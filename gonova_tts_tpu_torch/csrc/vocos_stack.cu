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
// What bounds it on the H100: the two MLP GEMMs are ~99% of the operations
// (2 * 2 * C * F per frame per block: ~25 MFLOP a frame at C=512, F=1536, L=8),
// so the stack is compute-bound. This first version runs them on the CUDA cores
// from shared-memory tiles; wgmma tiles fed by TMA and keeping h [rows, F] on
// chip (one fused MLP per row tile) are the path to the bound.
//
// bf16 mode rounds where the Pallas kernel rounds: the normalized input of w1,
// h before the GELU (so GELU sees the bf16 value), gamma * h before the residual
// add, and the stored activation.
#include "common.cuh"

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

}  // namespace port

// dtype 0 = float32, 1 = bfloat16 (activation, w1, w2; everything else float32).
// `act` [B, T, C] is updated in place. Returns a cudaError_t code.
extern "C" int vocos_stack_forward(int dtype, int B, int Tn, int C, int F, int L, void* act,
                                   const void* dw, const void* dwb, const void* ln_g,
                                   const void* ln_b, const void* w1, const void* b1,
                                   const void* w2, const void* b2, const void* gamma,
                                   void* normed, void* h, void* stream) {
  auto s = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
#define PORT_ARGS(T)                                                                     \
  B, Tn, C, F, L, (T*)act, f(dw), f(dwb), f(ln_g), f(ln_b), (const T*)w1, f(b1),         \
      (const T*)w2, f(b2), f(gamma), (T*)normed, (T*)h, s
  if (dtype == 0) return port::stack_forward<float>(PORT_ARGS(float));
  if (dtype == 1) return port::stack_forward<__nv_bfloat16>(PORT_ARGS(__nv_bfloat16));
#undef PORT_ARGS
  return (int)cudaErrorInvalidValue;
}
