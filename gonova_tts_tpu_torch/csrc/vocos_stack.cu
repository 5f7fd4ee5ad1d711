// Vocos ConvNeXt stack for Hopper (sm_90a): L blocks of
//   depthwise k=7 conv (zero edges) + bias -> f32 LN -> @w1 + b1 -> tanh-GELU
//   -> @w2 + b2 -> x + gamma * h
//
// Replaces gonova_tts_tpu/ops/vocos_stack_kernel.py::vocos_stack_pallas (one
// pallas_call with the activation resident in VMEM and the MLP weights streamed
// per block). Here the host loops over the blocks and launches, per block:
//   dwconv_ln (common.cuh; one block per (b, t) row: the 7 taps, the bias and the LN in f32)
//   -> gemm w1 with a GELU epilogue -> gemm w2 with the layer-scale residual
//   epilogue, written in place into the activation.
//
// What bounds it on the H100: operations. The two MLP GEMMs are ~99% of them
// (2 * 2 * C * F per frame per block: ~25 MFLOP a frame at C=512, F=1536, L=8).
// What this design does about it, in bf16: both products go through the tensor-core
// GEMM of gemm_tc.cuh (wgmma fed by a TMA ring; 64 x 128 tiles, 128 x 128 where that
// still gives two blocks an SM, chosen in ops/gemm_tc.py::plan). w2 (K = F = 1536, N = C = 512) has
// few output tiles and a long K loop, but a K split, which may not depend on M if a
// row's sum is to be the same at every T, only paid below M = 1280 when measured
// (ops/gemm_tc_sweep.py), so it runs unsplit. float32 keeps the CUDA-core GEMM of
// common.cuh, bit for bit. h [rows, F] still goes through device memory between w1
// and w2, and the 24 launches a stack are the next bound at the streaming window's
// size.
//
// bf16 mode rounds where the Pallas kernel rounds: the normalized input of w1,
// h before the GELU (so GELU sees the bf16 value), gamma * h before the residual
// add, and the stored activation.
#include "gemm_tc.cuh"

namespace port {

template <typename T>
int stack_forward(int B, int Tn, int C, int F, int L, T* act, const float* dw, const float* dwb,
                  const float* ln_g, const float* ln_b, const T* w1, const float* b1, const T* w2,
                  const float* b2, const float* gamma, T* normed, T* h, cudaStream_t s) {
  const int M = B * Tn;
  for (int l = 0; l < L; ++l) {
    dwconv_ln_kernel<T><<<M, DW_THREADS, 0, s>>>(act, normed, dw + (size_t)l * 7 * C,
                                                 dwb + (size_t)l * C, ln_g + (size_t)l * C,
                                                 ln_b + (size_t)l * C, Tn, C, 1e-5f);
    PORT_RETURN_IF_ERROR();
    gemm<T, A_ROWS, EPI_GELU>(normed, w1 + (size_t)l * C * F, h, M, F, C, Tn, C,
                              b1 + (size_t)l * F, nullptr, nullptr, nullptr, s);
    PORT_RETURN_IF_ERROR();
    gemm<T, A_ROWS, EPI_GAMMA_RESID>(h, w2 + (size_t)l * F * C, act, M, C, F, Tn, F,
                                     b2 + (size_t)l * C, act, nullptr, gamma + (size_t)l * C, s);
    PORT_RETURN_IF_ERROR();
  }
  return 0;
}

// The bf16 stack: w1_t [L, F, C] and w2_t [L, C, F] are the transposed copies of
// pack_params; plans holds (warpgroups, tile columns, split) for w1 and for w2; ws is
// the f32 workspace of the split product.
inline int stack_forward_tc(int B, int Tn, int C, int F, int L, __nv_bfloat16* act, const float* dw,
                            const float* dwb, const float* ln_g, const float* ln_b,
                            const __nv_bfloat16* w1_t, const float* b1, const __nv_bfloat16* w2_t,
                            const float* b2, const float* gamma, __nv_bfloat16* normed, __nv_bfloat16* h,
                            const int* plans, float* ws, cudaStream_t s) {
  using T = __nv_bfloat16;
  const int M = B * Tn;
  const tc::Plan p_1{plans[0], plans[1], plans[2]}, p_2{plans[3], plans[4], plans[5]};
  for (int l = 0; l < L; ++l) {
    dwconv_ln_kernel<T><<<M, DW_THREADS, 0, s>>>(act, normed, dw + (size_t)l * 7 * C,
                                                 dwb + (size_t)l * C, ln_g + (size_t)l * C,
                                                 ln_b + (size_t)l * C, Tn, C, 1e-5f);
    PORT_RETURN_IF_ERROR();
    int rc = tc::gemm_tc(normed, w1_t + (size_t)l * C * F, h, 1, M, C, 1, F, EPI_GELU, b1 + (size_t)l * F,
                         nullptr, nullptr, nullptr, ws, p_1, s);
    if (rc) return rc;
    rc = tc::gemm_tc(h, w2_t + (size_t)l * F * C, act, 1, M, F, 1, C, EPI_GAMMA_RESID, b2 + (size_t)l * C,
                     act, nullptr, gamma + (size_t)l * C, ws, p_2, s);
    if (rc) return rc;
  }
  return 0;
}

}  // namespace port

// dtype 0 = float32, 1 = bfloat16 (activation, w1, w2; everything else float32).
// `act` [B, T, C] is updated in place. float32 reads w1 and w2 as packed ([K, N]) and
// ignores `plans` and `ws`; bfloat16 reads their transposed copies and the two
// products' plans (6 ints, host memory). Returns a cudaError_t code.
extern "C" int vocos_stack_forward(int dtype, int B, int Tn, int C, int F, int L, void* act,
                                   const void* dw, const void* dwb, const void* ln_g,
                                   const void* ln_b, const void* w1, const void* b1,
                                   const void* w2, const void* b2, const void* gamma,
                                   void* normed, void* h, const void* plans, void* ws, void* stream) {
  auto s = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
#define PORT_ARGS(T)                                                                     \
  B, Tn, C, F, L, (T*)act, f(dw), f(dwb), f(ln_g), f(ln_b), (const T*)w1, f(b1),         \
      (const T*)w2, f(b2), f(gamma), (T*)normed, (T*)h
  if (dtype == 0) return port::stack_forward<float>(PORT_ARGS(float), s);
  if (dtype == 1)
    return port::stack_forward_tc(PORT_ARGS(__nv_bfloat16), (const int*)plans, (float*)ws, s);
#undef PORT_ARGS
  return (int)cudaErrorInvalidValue;
}
