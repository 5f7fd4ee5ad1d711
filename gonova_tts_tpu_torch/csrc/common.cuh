// Shared pieces of the port's hand-written Hopper kernels: dtype conversion,
// warp reductions, a row LayerNorm, the ConvNeXt depthwise-conv + LayerNorm row
// kernel, and one tiled shared-memory GEMM template with the epilogues the layer
// stacks and the single ConvNeXt block need.
//
// Storage type T is float or __nv_bfloat16 (the compute dtype); every product is
// accumulated in f32, and results are rounded to T exactly where the Pallas
// kernels round (round to nearest even, as torch's .to(bfloat16)).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PORT_RETURN_IF_ERROR()                 \
  do {                                         \
    cudaError_t e_ = cudaGetLastError();       \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

namespace port {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The value v takes once stored in T.
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}

// y[r] = LN(x[r]) over D columns: one warp per row, f32 mean and population
// variance (two passes over the row), result rounded to T.
template <typename T>
__global__ void ln_rows_kernel(const T* __restrict__ x, T* __restrict__ y,
                               const float* __restrict__ g, const float* __restrict__ b,
                               int rows, int D, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += to_f<T>(xr[c]);
  const float mean = warp_sum(s) / D;
  float v = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = to_f<T>(xr[c]) - mean;
    v += d * d;
  }
  const float rstd = 1.0f / sqrtf(warp_sum(v) / D + eps);
  T* yr = y + (size_t)row * D;
  for (int c = lane; c < D; c += 32) yr[c] = from_f<T>((to_f<T>(xr[c]) - mean) * rstd * g[c] + b[c]);
}

template <typename T>
inline void ln_rows(const T* x, T* y, const float* g, const float* b, int rows, int D,
                    float eps, cudaStream_t s) {
  const int warps_per_block = 8;
  ln_rows_kernel<T><<<(rows + warps_per_block - 1) / warps_per_block, 32 * warps_per_block, 0, s>>>(
      x, y, g, b, rows, D, eps);
}

// ------------------------------------------------------------------ dwconv + LN

constexpr int DW_THREADS = 128;
constexpr int DW_MAX_PER_THREAD = 8;  // C <= 1024

// y[row] = LN(depthwise k=7 conv of x over time (zero edges) + bias): one block per
// (b, t) row, taps, bias and LN statistics in f32, result rounded to TO. dw is
// [7, C]; x is read as TI (the activation dtype), y written as TO (the MLP dtype).
template <typename TI, typename TO = TI>
__global__ void __launch_bounds__(DW_THREADS)
dwconv_ln_kernel(const TI* __restrict__ x, TO* __restrict__ y, const float* __restrict__ dw,
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
        if (ts >= 0 && ts < Tn) a += to_f<TI>(x[(size_t)(row + j - 3) * C + c]) * dw[j * C + c];
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
    if (c < C) y[(size_t)row * C + c] = from_f<TO>((vals[u] - mean) * rstd * g[c] + b[c]);
  }
}

// ------------------------------------------------------------------ GEMM
//
// C[M, N] = epilogue(A'[M, K] @ W[K, N]), W row-major [K, N] (the JAX [in, out]
// layout; a k=3 conv weight [3, Cin, Cout] is the same memory as [3*Cin, Cout]).
//   A_ROWS:  A' = A, row-major [M, K].
//   A_CONV3: implicit im2col of a k=3 SAME conv over sequences of length T_len:
//            row m = (b, t) of A' is [A[b, t-1], A[b, t], A[b, t+1]] (K = 3*Cin),
//            with zero rows past each sequence's edges, so no tap crosses
//            sequences. Needs Cin % BK == 0 so a K tile never spans two taps.
enum AMode { A_ROWS = 0, A_CONV3 = 1 };

// Epilogues; v = acc + bias[n] in f32.
//   EPI_BIAS:        C = T(v)
//   EPI_BIAS_RELU:   C = T(max(v, 0))
//   EPI_RESID_MASK:  C = T(T(R + T(v)) * mask[m])      (residual + row mask)
//   EPI_GELU:        C = T(gelu_tanh(T(v)))
//   EPI_GAMMA_RESID: C = T(R + T(v * gamma[n]))        (layer-scale residual)
//   EPI_GELU_F32:    C = T(gelu_tanh(v))               (GELU of the f32 sum)
// R is resid[m, n], which may alias C (each element is read, then written, by
// the same thread). A and W are stored as T; C and R as TC (T unless given), and
// the roundings above are then to TC.
enum Epi {
  EPI_BIAS = 0, EPI_BIAS_RELU = 1, EPI_RESID_MASK = 2, EPI_GELU = 3, EPI_GAMMA_RESID = 4,
  EPI_GELU_F32 = 5
};

constexpr int BM = 64, BN = 64, BK = 16, GEMM_THREADS = 256;

template <typename T, int AMODE, int EPI, typename TC = T>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ W, TC* C, int M, int N, int K,
            int T_len, int Cin, const float* __restrict__ bias, const TC* resid,
            const float* __restrict__ mask, const float* __restrict__ gamma) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Ws[BK][BN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tr = tid / 16, tc = tid % 16;  // each thread owns a 4 x 4 output patch
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += GEMM_THREADS) {
      const int r = i / BK, kk = i % BK;
      const int m = m0 + r, k = k0 + kk;
      float v = 0.f;
      if (m < M) {
        if (AMODE == A_ROWS) {
          v = to_f<T>(A[(size_t)m * K + k]);
        } else {
          const int tap = k / Cin, c = k - tap * Cin;
          const int ts = (m % T_len) + tap - 1;
          if (ts >= 0 && ts < T_len) v = to_f<T>(A[(size_t)(m + tap - 1) * Cin + c]);
        }
      }
      As[kk][r] = v;
    }
    for (int i = tid; i < BK * BN; i += GEMM_THREADS) {
      const int kk = i / BN, c = i % BN;
      const int n = n0 + c;
      Ws[kk][c] = (n < N) ? to_f<T>(W[(size_t)(k0 + kk) * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][tr * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&Ws[kk][tc * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tr * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tc * 4 + j;
      if (n >= N) continue;
      const size_t o = (size_t)m * N + n;
      const float v = acc[i][j] + bias[n];
      float out;
      if (EPI == EPI_BIAS) {
        out = v;
      } else if (EPI == EPI_BIAS_RELU) {
        out = fmaxf(v, 0.f);
      } else if (EPI == EPI_RESID_MASK) {
        out = rnd<TC>(to_f<TC>(resid[o]) + rnd<TC>(v)) * mask[m];
      } else if (EPI == EPI_GELU) {
        out = gelu_tanh(rnd<TC>(v));
      } else if (EPI == EPI_GELU_F32) {
        out = gelu_tanh(v);
      } else {  // EPI_GAMMA_RESID
        out = to_f<TC>(resid[o]) + rnd<TC>(v * gamma[n]);
      }
      C[o] = from_f<TC>(out);
    }
  }
}

// TC is never deduced (a null `resid` has no pointee type to deduce from): it is
// T unless the caller names it.
template <typename U> struct same_type { using type = U; };

template <typename T, int AMODE, int EPI, typename TC = T>
inline void gemm(const T* A, const T* W, typename same_type<TC>::type* C, int M, int N, int K,
                 int T_len, int Cin, const float* bias, const typename same_type<TC>::type* resid,
                 const float* mask, const float* gamma, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<T, AMODE, EPI, TC><<<grid, GEMM_THREADS, 0, s>>>(A, W, C, M, N, K, T_len, Cin,
                                                               bias, resid, mask, gamma);
}

}  // namespace port

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
