// The bf16 tensor-core GEMM of gemm_tc.cuh behind a C entry point of its own, so
// that the product can be tested and timed apart from the two stacks that use it.
#include "gemm_tc.cuh"

// C [B*T, N] = epilogue(A' @ Wt^T) in bf16; see port::tc::gemm_tc for the operands.
// epi is a port::Epi value (EPI_BIAS .. EPI_GAMMA_RESID); wgs, bn and split are the
// plan of ops/gemm_tc.py. Returns a cudaError_t code.
extern "C" int gemm_tc_forward(int B, int T_len, int Cin, int taps, int N, int epi, int wgs, int bn,
                               int split, const void* A, const void* Wt, void* C, const void* bias,
                               const void* resid, const void* mask, const void* gamma, void* ws,
                               void* stream) {
  using port::tc::bf16;
  if (epi < port::EPI_BIAS || epi > port::EPI_GAMMA_RESID) return (int)cudaErrorInvalidValue;
  return port::tc::gemm_tc((const bf16*)A, (const bf16*)Wt, (bf16*)C, B, T_len, Cin, taps, N, epi,
                           (const float*)bias, (const bf16*)resid, (const float*)mask,
                           (const float*)gamma, (float*)ws, port::tc::Plan{wgs, bn, split},
                           (cudaStream_t)stream);
}
