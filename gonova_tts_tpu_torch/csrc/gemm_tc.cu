// The bf16 tensor-core GEMM of gemm_tc.cuh behind a C entry point of its own, so
// that the product can be tested and timed apart from the kernels that use it.
#include "gemm_tc.cuh"

namespace {
// EPI_GELU_F32 is EPI_GELU in the kernels compiled with F32_GELU: this entry point
// builds both, the ConvNeXt block only the one it runs.
template <typename TO>
int forward(int B, int T_len, int Cin, int taps, int N, int epi, port::tc::Plan plan, const void* A,
            const void* Wt, void* C, const void* bias, const void* resid, const void* mask, const void* gamma,
            void* ws, cudaStream_t s) {
  using port::tc::bf16;
  const auto a = (const bf16*)A, wt = (const bf16*)Wt;
  const auto f = [](const void* p) { return (const float*)p; };
  if (epi == port::EPI_GELU_F32)
    return port::tc::gemm_tc<TO, true>(a, wt, (TO*)C, B, T_len, Cin, taps, N, port::EPI_GELU, f(bias),
                                       (const TO*)resid, f(mask), f(gamma), (float*)ws, plan, s);
  return port::tc::gemm_tc<TO, false>(a, wt, (TO*)C, B, T_len, Cin, taps, N, epi, f(bias), (const TO*)resid,
                                      f(mask), f(gamma), (float*)ws, plan, s);
}
}  // namespace

// C [B*T, N] = epilogue(A' @ Wt^T); see port::tc::gemm_tc for the operands. epi is a
// port::Epi value (EPI_BIAS .. EPI_GELU_F32); C and resid are float32 when out_f32,
// else bf16; wgs, bn and split are the plan of ops/gemm_tc.py. Returns a cudaError_t
// code.
extern "C" int gemm_tc_forward(int B, int T_len, int Cin, int taps, int N, int epi, int out_f32, int wgs,
                               int bn, int split, const void* A, const void* Wt, void* C, const void* bias,
                               const void* resid, const void* mask, const void* gamma, void* ws,
                               void* stream) {
  if (epi < port::EPI_BIAS || epi > port::EPI_GELU_F32) return (int)cudaErrorInvalidValue;
  const port::tc::Plan plan{wgs, bn, split};
  const auto s = (cudaStream_t)stream;
  if (out_f32) return forward<float>(B, T_len, Cin, taps, N, epi, plan, A, Wt, C, bias, resid, mask, gamma, ws, s);
  return forward<port::tc::bf16>(B, T_len, Cin, taps, N, epi, plan, A, Wt, C, bias, resid, mask, gamma, ws, s);
}
