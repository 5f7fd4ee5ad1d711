// Vocos ConvNeXt stack for Hopper (sm_90a): L blocks of
//   depthwise k=7 conv (zero edges) + bias -> f32 LN -> @w1 + b1 -> tanh-GELU
//   -> @w2 + b2 -> x + gamma * h
//
// Replaces gonova_tts_tpu/ops/vocos_stack_kernel.py::vocos_stack_pallas (one
// pallas_call with the activation resident in VMEM and the MLP weights streamed
// per block). Here the host loops over the blocks and launches, per block:
//   dwconv_ln (one block per (b, t) row: the 7 taps, the bias and the LN in f32)
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

constexpr int DW_THREADS = 128;
constexpr int DW_MAX_PER_THREAD = 8;  // C <= 1024

template <typename T>
__global__ void __launch_bounds__(DW_THREADS)
dwconv_ln_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ dw,
                 const float* __restrict__ dwb, const float* __restrict__ g,
                 const float* __restrict__ b, int Tn, int C, float eps) {
  __shared__ float red[DW_THREADS / 32];
  const int row = blockIdx.x, t = row % Tn;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float vals[DW_MAX_PER_THREAD];
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < DW_MAX_PER_THREAD; ++u) {
    const int c = threadIdx.x + DW_THREADS * u;
    float a = 0.f;
    if (c < C) {
      a = dwb[c];
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        const int ts = t + j - 3;
        if (ts >= 0 && ts < Tn) a += to_f<T>(x[(size_t)(row + j - 3) * C + c]) * dw[j * C + c];
      }
      s += a;
    }
    vals[u] = a;
  }
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < DW_THREADS / 32; ++w) tot += red[w];
  const float mean = tot / C;
  __syncthreads();
  float v = 0.f;
#pragma unroll
  for (int u = 0; u < DW_MAX_PER_THREAD; ++u) {
    const int c = threadIdx.x + DW_THREADS * u;
    if (c < C) v += (vals[u] - mean) * (vals[u] - mean);
  }
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  tot = 0.f;
#pragma unroll
  for (int w = 0; w < DW_THREADS / 32; ++w) tot += red[w];
  const float rstd = 1.0f / sqrtf(tot / C + eps);
#pragma unroll
  for (int u = 0; u < DW_MAX_PER_THREAD; ++u) {
    const int c = threadIdx.x + DW_THREADS * u;
    if (c < C) y[(size_t)row * C + c] = from_f<T>((vals[u] - mean) * rstd * g[c] + b[c]);
  }
}

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
