// One ConvNeXt block for Hopper (sm_90a):
//   depthwise k=7 conv (zero edges) + bias -> f32 LN -> @w1 + b1 -> tanh-GELU
//   -> @w2 + b2 -> x + (h * gamma) rounded to x's dtype
//
// Replaces gonova_tts_tpu/ops/convnext_kernel.py::convnext_block_pallas (halo'd
// 256-frame tiles resident in VMEM, two batch rows a grid step). Here T is any
// length with no padding, and the block is three launches written to a new output:
// dwconv_ln (common.cuh), the w1 product with the GELU epilogue, the w2 product with
// the layer-scale residual epilogue.
//
// It is not one iteration of vocos_stack.cu. As in the Pallas kernel it replaces,
//   * the activation dtype TX is x's own and the MLP operand dtype TM is chosen
//     by the bf16 flag, independently: an f32 x with bf16 MLP operands is legal;
//   * the LN output is cast straight from f32 to TM;
//   * the GELU sees the f32 sum `normed @ w1 + b1`, and only its result is cast
//     to TM (EPI_GELU_F32; the stack rounds the sum to bf16 first);
//   * h * gamma is rounded to TX before the residual add, and the sum again.
//
// What bounds it on the H100: operations, the two MLP products (4 * C * F per frame,
// ~3.1 MFLOP at C=512, F=1536, ~99% of the block's work). What the design does:
//   * bf16 MLP operands (x f32 or bf16): both products run on the tensor cores
//     through the shared wgmma GEMM of gemm_tc.cuh, with the tile and K split planned
//     in ops/gemm_tc.py and the [N, K] weight copies the wrapper caches. Its output
//     type follows the product: h is bf16, the w2 epilogue reads the residual x and
//     writes out in TX, so an f32 x keeps an f32 residual path (r + f32(v * gamma)).
//     C and F must be multiples of 64 (a K tile is 64 bf16).
//   * f32 MLP operands: common.cuh's CUDA-core GEMM, unchanged, so that eight blocks
//     in f32 give the f32 stack kernel's bits.
#include "gemm_tc.cuh"

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

// bf16 MLP operands on the tensor cores: w1_t [F, C] and w2_t [C, F] are the [N, K]
// copies; plans holds (warpgroups, tile columns, split) of w1 and of w2; ws is the f32
// workspace of a split product.
template <typename TX>
int block_forward_tc(int B, int Tn, int C, int F, float eps, const TX* x, TX* out, const float* dw,
                     const float* dwb, const float* ln_g, const float* ln_b, const tc::bf16* w1_t,
                     const float* b1, const tc::bf16* w2_t, const float* b2, const float* gamma,
                     tc::bf16* normed, tc::bf16* h, const int* plans, float* ws, cudaStream_t s) {
  const int M = B * Tn;
  if (M <= 0) return 0;
  dwconv_ln_kernel<TX, tc::bf16><<<M, DW_THREADS, 0, s>>>(x, normed, dw, dwb, ln_g, ln_b, Tn, C, eps);
  PORT_RETURN_IF_ERROR();
  const tc::Plan p_1{plans[0], plans[1], plans[2]}, p_2{plans[3], plans[4], plans[5]};
  // EPI_GELU_F32: EPI_GELU in the kernels compiled with F32_GELU.
  const int rc = tc::gemm_tc<tc::bf16, true>(normed, w1_t, h, 1, M, C, 1, F, EPI_GELU, b1, nullptr, nullptr,
                                             nullptr, ws, p_1, s);
  if (rc) return rc;
  return tc::gemm_tc(h, w2_t, out, 1, M, F, 1, C, EPI_GAMMA_RESID, b2, x, nullptr, gamma, ws, p_2, s);
}

}  // namespace port

// x_dtype and mlp_dtype: 0 = float32, 1 = bfloat16. x and out [B, T, C] are x_dtype;
// the scratch buffers normed [B*T, C] and h [B*T, F] are mlp_dtype; everything else
// float32 except the MLP weights: float32 reads w1 [C, F] and w2 [F, C] and ignores
// plans and ws; bfloat16 reads their [N, K] copies w1_t [F, C] and w2_t [C, F], the two
// products' plans (6 ints, host memory) and the split workspace. Returns a cudaError_t code.
extern "C" int convnext_block_forward(int x_dtype, int mlp_dtype, int B, int Tn, int C, int F,
                                      float eps, const void* x, void* out, const void* dw,
                                      const void* dwb, const void* ln_g, const void* ln_b,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* b2, const void* gamma, void* normed, void* h,
                                      const void* plans, void* ws, void* stream) {
  auto s = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  if (C > port::DW_THREADS * port::DW_MAX_PER_THREAD) return (int)cudaErrorInvalidValue;
#define PORT_ARGS(TX, TM)                                                                    \
  B, Tn, C, F, eps, (const TX*)x, (TX*)out, f(dw), f(dwb), f(ln_g), f(ln_b), (const TM*)w1, \
      f(b1), (const TM*)w2, f(b2), f(gamma), (TM*)normed, (TM*)h
  using bf = __nv_bfloat16;
  if (x_dtype == 0 && mlp_dtype == 0) return port::block_forward<float, float>(PORT_ARGS(float, float), s);
  if (x_dtype == 1 && mlp_dtype == 0) return port::block_forward<bf, float>(PORT_ARGS(bf, float), s);
  if (x_dtype == 0 && mlp_dtype == 1)
    return port::block_forward_tc<float>(PORT_ARGS(float, bf), (const int*)plans, (float*)ws, s);
  if (x_dtype == 1 && mlp_dtype == 1)
    return port::block_forward_tc<bf>(PORT_ARGS(bf, bf), (const int*)plans, (float*)ws, s);
#undef PORT_ARGS
  return (int)cudaErrorInvalidValue;
}
