// Anti-aliased Snake-beta for Hopper (sm_90a): BigVGAN-v2's
// Activation1d(UpSample1d, SnakeBeta, DownSample1d) in one launch.
//
// No TPU kernel stands behind it (the JAX package has no BigVGAN); the plain version
// is ops/snake_aa.py::snake_aa_plain. Per channel c of one row x[t], t < T:
//   u[2p]   = 2 * sum_{i<6} f[2i+1] * x[clamp(p+2-i)]     (upsample x2: the replicate
//   u[2p+1] = 2 * sum_{i<6} f[2i]   * x[clamp(p+3-i)]      pad by 5 and the crop by 15)
//   a[n]    = u[n] + inv_beta[c] * sin(alpha[c] * u[n])^2  (Snake-beta, f32)
//   y[t]    = sum_{j<12} f[j] * a[clamp2(2t+j-5)]          (downsample x2)
// clamp to [0, T-1], clamp2 to [0, 2T-1]: the downsampler's replicate pad repeats the
// activated upsampled edge sample, not the input's.
//
// Layout: rows of T samples, one row per (b, c): x [B, T, C] lying as [B, C, T], the
// layout the port's conv1d returns (cuDNN's NCW output seen through a transpose), so
// the activation between two convs copies nothing.
//
// What bounds it on the H100: bytes, by the benchmark's count (58 operations and 4
// bytes a sample in bf16, against the card's 20 f32 operations a byte). Each sample
// is read once and written once; the 2T-long upsampled signal never leaves registers.
// A warp owns a segment of SEG outputs of one row: it stages x over the segment and a
// halo of 6 samples a side into shared memory (coalesced, as f32), then each lane
// takes R consecutive outputs: its R + 12 inputs from shared memory into registers,
// the 2R + 12 activated samples they need, the R outputs, which go back through
// shared memory to a coalesced store. A lane whose outputs reach a row's edge swaps
// the activated samples that lie past it for the edge's own (selects over the
// unrolled array: no lane takes another path, so no warp waits on one). No
// __syncthreads: warps are independent. bf16 takes the hardware sine (__sinf, error
// ~1e-6 for arguments of a few units, far below a bf16 step); f32 takes sinf.
#include "common.cuh"

namespace {

constexpr int TAPS = 12;
constexpr int HALO = 6;
// R and WARPS, with three blocks an SM: the fastest of R 4-16 and 4 or 8 warps at the
// published stages' shapes (by 1-8% over 8 warps; 25-34% of the bytes' bound, H100).
constexpr int R = 16;               // outputs per lane
constexpr int WARPS = 4;            // warps per block
constexpr int MIN_BLOCKS = 3;       // per SM, for __launch_bounds__
constexpr int SEG = 32 * R;         // outputs per warp
constexpr int XN = SEG + 2 * HALO;  // inputs staged per warp
constexpr int XSLOTS = XN + XN / R + 1;
constexpr int YSLOTS = SEG + SEG / R;
static_assert(R >= 3, "a lane's first output is 0 or at least 3 samples into its row");

struct Taps {
  float f[TAPS];
};

// Shared-memory slot of element i: one pad word every R, so lane l's window
// (starting at l * R) starts in bank 17 * l mod 32: no two lanes share a bank.
__device__ __forceinline__ int slot(int i) { return i + i / R; }

template <bool FAST>
__device__ __forceinline__ float snake(float u, float alpha, float inv_beta) {
  const float s = FAST ? __sinf(alpha * u) : sinf(alpha * u);
  return fmaf(inv_beta, s * s, u);
}

template <typename T, bool FAST>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
    snake_aa_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ alpha,
                    const float* __restrict__ inv_beta, Taps taps, int C, int T_len, long long rows,
                    int segs) {
  __shared__ float xs_all[WARPS][XSLOTS];
  __shared__ float ys_all[WARPS][YSLOTS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * WARPS + warp;
  if (item >= rows * segs) return;  // the whole warp: it syncs with no other
  const long long row = item / segs;
  const int t0 = (int)(item % segs) * SEG;
  const T* xr = x + row * (long long)T_len;
  T* yr = y + row * (long long)T_len;
  const int c = (int)(row % C);
  const float al = alpha[c], ib = inv_beta[c];
  float* xs = xs_all[warp];
  float* ys = ys_all[warp];
  const float* f = taps.f;

#pragma unroll
  for (int i = lane; i < XN; i += 32) {
    const int t = min(max(t0 - HALO + i, 0), T_len - 1);
    xs[slot(i)] = port::to_f<T>(xr[t]);
  }
  __syncwarp();

  const int tl = t0 + lane * R;  // this lane's first output
  if (tl < T_len) {
    // xv[i] = x[tl - 6 + i] (clamped); av[2q + par] = a[2(tl - 3 + q) + par].
    float xv[R + 12];
#pragma unroll
    for (int i = 0; i < R + 12; ++i) xv[i] = xs[slot(lane * R + i)];
    float av[2 * R + 12];
#pragma unroll
    for (int q = 0; q < R + 6; ++q) {
      float ue = 0.f, uo = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        ue = fmaf(f[2 * i + 1], xv[q + 5 - i], ue);
        uo = fmaf(f[2 * i], xv[q + 6 - i], uo);
      }
      av[2 * q] = snake<FAST>(2.f * ue, al, ib);
      av[2 * q + 1] = snake<FAST>(2.f * uo, al, ib);
    }
    if (tl < 3 || tl + R + 3 > T_len) {
      // A row's edge: a[n] for n < 0 is a[0] (slot j0) and for n > 2T - 1 it is
      // a[2T - 1] (slot j1), the downsampler's replicate pad of the activated signal.
      const int j0 = 6 - 2 * tl, j1 = 2 * T_len + 5 - 2 * tl;
      float a_lo = 0.f, a_hi = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * R + 12; ++j) {
        a_lo = j == j0 ? av[j] : a_lo;
        a_hi = j == j1 ? av[j] : a_hi;
      }
#pragma unroll
      for (int j = 0; j < 2 * R + 12; ++j) av[j] = j < j0 ? a_lo : (j > j1 ? a_hi : av[j]);
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < TAPS; ++j) acc = fmaf(f[j], av[2 * k + j + 1], acc);
      ys[slot(lane * R + k)] = acc;
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < SEG; i += 32) {
    const int t = t0 + i;
    if (t < T_len) yr[t] = port::from_f<T>(ys[slot(i)]);
  }
}

template <typename T, bool FAST>
int launch(const void* x, void* y, const float* alpha, const float* inv_beta, const float* f, int B,
           int C, int T_len, cudaStream_t stream) {
  Taps taps;
  for (int j = 0; j < TAPS; ++j) taps.f[j] = f[j];
  const long long rows = (long long)B * C;
  const int segs = (T_len + SEG - 1) / SEG;
  const long long blocks = (rows * segs + WARPS - 1) / WARPS;
  snake_aa_kernel<T, FAST><<<(unsigned)blocks, WARPS * 32, 0, stream>>>(
      (const T*)x, (T*)y, alpha, inv_beta, taps, C, T_len, rows, segs);
  PORT_RETURN_IF_ERROR();
  return 0;
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (x and y; alpha, inv_beta [C] and the 12 taps
// float32, the taps in host memory). x and y lie as [B, C, T]. Returns a
// cudaError_t code.
extern "C" int snake_aa_forward(int dtype, int B, int C, int T, const void* x, void* y, const void* alpha,
                                const void* inv_beta, const void* taps, void* stream) {
  if (B <= 0 || C <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto a = (const float*)alpha, ib = (const float*)inv_beta, f = (const float*)taps;
  if (dtype == 0) return launch<float, false>(x, y, a, ib, f, B, C, T, s);
  if (dtype == 1) return launch<__nv_bfloat16, true>(x, y, a, ib, f, B, C, T, s);
  return (int)cudaErrorInvalidValue;
}
