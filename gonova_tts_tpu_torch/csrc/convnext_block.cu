// One ConvNeXt block for Hopper (sm_90a):
//   depthwise k=7 conv (zero edges) + bias -> f32 LN -> @w1 + b1 -> tanh-GELU
//   -> @w2 + b2 -> x + (h * gamma) rounded to x's dtype
//
// Replaces gonova_tts_tpu/ops/convnext_kernel.py::convnext_block_pallas (halo'd
// 256-frame tiles resident in VMEM, two batch rows a grid step). Here T is any
// length with no padding, and the block is three launches that share their code
// with the stack kernel (common.cuh): dwconv_ln, gemm w1 with the GELU epilogue,
// gemm w2 with the layer-scale residual epilogue, written to a new output.
//
// It is not one iteration of vocos_stack.cu. As in the Pallas kernel it replaces,
//   * the activation dtype TX is x's own and the MLP operand dtype TM is chosen
//     by the bf16 flag, independently: an f32 x with bf16 MLP operands is legal;
//   * the LN output is cast straight from f32 to TM;
//   * the GELU sees the f32 sum `normed @ w1 + b1`, and only its result is cast
//     to TM (the stack rounds the sum to bf16 first);
//   * h * gamma is rounded to TX before the residual add, and the sum again.
//
// What bounds it on the H100: operations, the two MLP GEMMs (4 * C * F per frame,
// ~3.1 MFLOP at C=512, F=1536, ~99% of the block). They run on the CUDA cores from
// shared-memory tiles with f32 accumulation; wgmma tiles are the path to the bound.
#include "common.cuh"

namespace port {

template <typename TX, typename TM>
int block_forward(int B, int Tn, int C, int F, float eps, const TX* x, TX* out, const float* dw,
                  const float* dwb, const float* ln_g, const float* ln_b, const TM* w1,
                  const float* b1, const TM* w2, const float* b2, const float* gamma, TM* normed,
                  TM* h, cudaStream_t s) {
  const int M = B * Tn;
  if (M <= 0) return 0;
  dwconv_ln_kernel<TX, TM><<<M, DW_THREADS, 0, s>>>(x, normed, dw, dwb, ln_g, ln_b, Tn, C, eps);
  PORT_RETURN_IF_ERROR();
  gemm<TM, A_ROWS, EPI_GELU_F32>(normed, w1, h, M, F, C, Tn, C, b1, nullptr, nullptr, nullptr, s);
  PORT_RETURN_IF_ERROR();
  gemm<TM, A_ROWS, EPI_GAMMA_RESID, TX>(h, w2, out, M, C, F, Tn, F, b2, x, nullptr, gamma, s);
  PORT_RETURN_IF_ERROR();
  return 0;
}

}  // namespace port

// x_dtype and mlp_dtype: 0 = float32, 1 = bfloat16. x and out [B, T, C] are x_dtype;
// w1 [C, F], w2 [F, C] and the scratch buffers normed [B*T, C], h [B*T, F] are
// mlp_dtype; everything else float32. Returns a cudaError_t code.
extern "C" int convnext_block_forward(int x_dtype, int mlp_dtype, int B, int Tn, int C, int F,
                                      float eps, const void* x, void* out, const void* dw,
                                      const void* dwb, const void* ln_g, const void* ln_b,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* b2, const void* gamma, void* normed, void* h,
                                      void* stream) {
  auto s = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  if (C > port::DW_THREADS * port::DW_MAX_PER_THREAD) return (int)cudaErrorInvalidValue;
#define PORT_ARGS(TX, TM)                                                                    \
  B, Tn, C, F, eps, (const TX*)x, (TX*)out, f(dw), f(dwb), f(ln_g), f(ln_b), (const TM*)w1, \
      f(b1), (const TM*)w2, f(b2), f(gamma), (TM*)normed, (TM*)h, s
  using bf = __nv_bfloat16;
  if (x_dtype == 0 && mlp_dtype == 0) return port::block_forward<float, float>(PORT_ARGS(float, float));
  if (x_dtype == 0 && mlp_dtype == 1) return port::block_forward<float, bf>(PORT_ARGS(float, bf));
  if (x_dtype == 1 && mlp_dtype == 0) return port::block_forward<bf, float>(PORT_ARGS(bf, float));
  if (x_dtype == 1 && mlp_dtype == 1) return port::block_forward<bf, bf>(PORT_ARGS(bf, bf));
#undef PORT_ARGS
  return (int)cudaErrorInvalidValue;
}
