// Log-mel spectrogram for Hopper (sm_90a):
//   reflect-padded audio -> framed DFT with the Hann window folded into the cos/sin
//   bases -> sqrt(max(re^2 + im^2, 1e-9)) -> slaney filterbank -> log(max(., eps))
//
// Replaces gonova_tts_tpu/ops/mel_kernel.py::mel_spectrogram_pallas. The Pallas
// kernel lays the audio out as hop-rows and adds n_fft / hop row-shifted matmuls,
// because its tiles cannot overlap. Here the frame matrix is a strided view of the
// padded audio: row (b, i) starts at xp[b, i * hop] with row stride hop, so a tile
// loader reads xp[b, i * hop + k] directly and any n_fft / hop ratio works.
//
// Two launches:
//   framed_dft_mag:  one block per (64 frames, 64 bins) tile; the audio tile is
//                    loaded once and feeds both the cos and the sin product
//                    (K = n_fft), magnitude in the epilogue -> mag [M, n_bins].
//   mel_project_log: [M, n_bins] @ [n_bins, n_mels], log(max(., eps)) epilogue.
//
// What bounds it on the H100: operations. A frame costs 2 * 2 * n_fft * n_bins +
// 2 * n_bins * n_mels ~ 2.2 MFLOP against ~1 KB of new audio, and every product
// must stay full f32 (the log near the eps floor amplifies input error), so the
// tensor cores are out and the ceiling is the f32 FMA rate of the CUDA cores.
// This first version is a plain shared-memory tile product with 4 x 4 outputs a
// thread; larger register tiles and double-buffered loads are the way to the bound.
#include "common.cuh"

namespace port {

constexpr int MEL_BM = 64, MEL_BN = 64, MEL_BK = 16, MEL_THREADS = 256;

__global__ void __launch_bounds__(MEL_THREADS)
framed_dft_mag_kernel(const float* __restrict__ xp, const float* __restrict__ wcos,
                      const float* __restrict__ wsin, float* __restrict__ mag, int n_frames,
                      int M, int Tp, int hop, int n_fft, int n_bins) {
  __shared__ __align__(16) float As[MEL_BK][MEL_BM + 4];
  __shared__ __align__(16) float Cs[MEL_BK][MEL_BN + 4];
  __shared__ __align__(16) float Ss[MEL_BK][MEL_BN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * MEL_BM, n0 = blockIdx.x * MEL_BN;
  const int tr = tid / 16, tc = tid % 16;  // each thread owns a 4 x 4 output patch
  float re[4][4], im[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

  // This thread loads column kk = tid % 16 of rows tid / 16 + 16 * u of the frame tile.
  const int a_kk = tid % MEL_BK, a_r = tid / MEL_BK;
  long long a_off[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int m = m0 + a_r + 16 * u;
    a_off[u] = (m < M) ? (long long)(m / n_frames) * Tp + (long long)(m % n_frames) * hop : -1;
  }

  for (int k0 = 0; k0 < n_fft; k0 += MEL_BK) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      As[a_kk][a_r + 16 * u] = (a_off[u] >= 0) ? xp[a_off[u] + k0 + a_kk] : 0.f;
    for (int i = tid; i < MEL_BK * MEL_BN; i += MEL_THREADS) {
      const int kk = i / MEL_BN, c = i % MEL_BN;
      const int n = n0 + c;
      const size_t o = (size_t)(k0 + kk) * n_bins + n;
      Cs[kk][c] = (n < n_bins) ? wcos[o] : 0.f;
      Ss[kk][c] = (n < n_bins) ? wsin[o] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < MEL_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][tr * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Cs[kk][tc * 4]);
      const float4 s = *reinterpret_cast<const float4*>(&Ss[kk][tc * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          re[i][j] = fmaf(av[i], cv[j], re[i][j]);
          im[i][j] = fmaf(av[i], sv[j], im[i][j]);
        }
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
      if (n < n_bins)
        mag[(size_t)m * n_bins + n] = sqrtf(fmaxf(re[i][j] * re[i][j] + im[i][j] * im[i][j], 1e-9f));
    }
  }
}

__global__ void __launch_bounds__(MEL_THREADS)
mel_project_log_kernel(const float* __restrict__ mag, const float* __restrict__ fb,
                       float* __restrict__ out, int M, int n_bins, int n_mels, float eps) {
  __shared__ __align__(16) float As[MEL_BK][MEL_BM + 4];
  __shared__ __align__(16) float Ws[MEL_BK][MEL_BN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * MEL_BM, n0 = blockIdx.x * MEL_BN;
  const int tr = tid / 16, tc = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < n_bins; k0 += MEL_BK) {
    for (int i = tid; i < MEL_BM * MEL_BK; i += MEL_THREADS) {
      const int r = i / MEL_BK, kk = i % MEL_BK;
      const int m = m0 + r, k = k0 + kk;
      As[kk][r] = (m < M && k < n_bins) ? mag[(size_t)m * n_bins + k] : 0.f;
    }
    for (int i = tid; i < MEL_BK * MEL_BN; i += MEL_THREADS) {
      const int kk = i / MEL_BN, c = i % MEL_BN;
      const int n = n0 + c, k = k0 + kk;
      Ws[kk][c] = (n < n_mels && k < n_bins) ? fb[(size_t)k * n_mels + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < MEL_BK; ++kk) {
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
      if (n < n_mels) out[(size_t)m * n_mels + n] = logf(fmaxf(acc[i][j], eps));
    }
  }
}

}  // namespace port

// xp [B, Tp] is the reflect-padded audio (Tp >= (n_frames - 1) * hop + n_fft), wcos
// and wsin [n_fft, n_bins] the window-folded bases, fb [n_bins, n_mels], mag
// [B * n_frames, n_bins] scratch, out [B, n_frames, n_mels]; all float32, n_fft a
// multiple of 16. Returns a cudaError_t code.
extern "C" int mel_spectrogram_forward(int B, int n_frames, int Tp, int hop, int n_fft, int n_bins,
                                       int n_mels, float eps, const void* xp, const void* wcos,
                                       const void* wsin, const void* fb, void* mag, void* out,
                                       void* stream) {
  using namespace port;
  auto s = (cudaStream_t)stream;
  const int M = B * n_frames;
  if (M <= 0) return 0;
  if (n_fft % MEL_BK != 0) return (int)cudaErrorInvalidValue;
  const int row_tiles = (M + MEL_BM - 1) / MEL_BM;
  framed_dft_mag_kernel<<<dim3((n_bins + MEL_BN - 1) / MEL_BN, row_tiles), MEL_THREADS, 0, s>>>(
      (const float*)xp, (const float*)wcos, (const float*)wsin, (float*)mag, n_frames, M, Tp, hop,
      n_fft, n_bins);
  PORT_RETURN_IF_ERROR();
  mel_project_log_kernel<<<dim3((n_mels + MEL_BN - 1) / MEL_BN, row_tiles), MEL_THREADS, 0, s>>>(
      (const float*)mag, (const float*)fb, (float*)out, M, n_bins, n_mels, eps);
  PORT_RETURN_IF_ERROR();
  return 0;
}
