// Anti-aliased Snake-beta for Hopper (sm_90a): BigVGAN-v2's
// Activation1d(UpSample1d, SnakeBeta, DownSample1d) in one launch.
//
// No TPU kernel stands behind it (the JAX package has no BigVGAN); the plain version
// is ops/snake_aa.py::snake_aa_plain. Per channel c of one row, with the input
// x'[t] = x[t] + bias[c] (bias optional: the conv before it leaves its bias here), t < T:
//   u[2p]   = 2 * sum_{i<6} f[2i+1] * x'[clamp(p+2-i)]   (upsample x2: the replicate
//   u[2p+1] = 2 * sum_{i<6} f[2i]   * x'[clamp(p+3-i)]    pad by 5 and the crop by 15)
//   a[n]    = u[n] + inv_beta[c] * sin(alpha[c] * u[n])^2  (Snake-beta, f32)
//   y[t]    = sum_{j<12} f[j] * a[clamp2(2t+j-5)]          (downsample x2)
// clamp to [0, T-1], clamp2 to [0, 2T-1]: the downsampler's replicate pad repeats the
// activated upsampled edge sample, not the input's.
//
// Layout: x and y [B, T, C] contiguous (channels-last), the layout BigVGAN's convs
// read and write (cuDNN's NHWC), so the activation between two convs copies nothing.
//
// What bounds it on the H100: bytes, by the benchmark's count (58 operations and 4
// bytes a sample in bf16, against the card's 20 f32 operations a byte), with the
// issue of ~40 f32 instructions a sample close behind: at the bytes' bound the SMs
// would issue about three quarters of their f32 rate. So the design spends no
// instruction on staging and keeps many warps in flight. A lane owns V neighbouring
// channels (one V-wide load of a time step; neighbouring lanes own neighbouring
// channels, so a warp reads one contiguous run of each time step) and a segment of
// SEG consecutive outputs, which it walks along time. Output t reads a[2t-5 .. 2t+6],
// the six pairs (a[2q+1], a[2q+2]) for q = t-3 .. t+2, and both samples of pair q
// come from the same six inputs x[q-2 .. q+3]. So each step loads one time step
// x[t+6], computes one pair and one output, and keeps the last five inputs and the
// twelve activated samples in registers: the loop is unrolled, so the ring's shifts
// are renamings. A segment's first output also reads x[t0-5 .. t0+5], straight from
// global memory (L1 and L2 hold the neighbouring segments' rows): no shared memory,
// no synchronisation. Only a segment that reaches a row's edge takes the path that
// clamps its loads and swaps the activated samples past the edge for the edge's own.
// bf16 takes the hardware sine (__sinf, error ~1e-6 for arguments of a few units,
// far below a bf16 step); f32 takes sinf.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// The taps as the kernel applies them. Pair q's samples both read x'[q+3-i], i < 6:
// a[2q+1] through odd[i] = 2 f[2i], a[2q+2] through even[i] = 2 f[2i+1].
struct Taps {
  float odd[6];
  float even[6];
  float down[12];
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// The library sine is called, not inlined: its slow path for large arguments, inlined
// into every unrolled step of every plan, multiplied the build's time by four.
__device__ __noinline__ float library_sin(float v) { return sinf(v); }

template <bool FAST>
__device__ __forceinline__ float snake(float u, float alpha, float inv_beta) {
  const float s = FAST ? __sinf(alpha * u) : library_sin(alpha * u);
  return fmaf(inv_beta, s * s, u);
}

template <typename T, int V, bool CLAMP>
__device__ __forceinline__ void load(const T* xc, int t, int C, int T_len, const float (&bs)[V],
                                     float (&out)[V]) {
  if (CLAMP) t = min(max(t, 0), T_len - 1);
  const Vec<T, V> r = *reinterpret_cast<const Vec<T, V>*>(xc + (long long)t * C);
#pragma unroll
  for (int v = 0; v < V; ++v) out[v] = port::to_f<T>(r.v[v]) + bs[v];
}

// Pair q = a[2q+1], a[2q+2] from w = x'[q-2 .. q+3]; on a row's edge path, the
// samples past 2T - 1 become a[2T - 1] (`last` carries it from pair T - 1 on).
template <bool FAST, int V, bool EDGE>
__device__ __forceinline__ void pair(const float (&w)[6][V], const Taps& tp, const float (&al)[V],
                                     const float (&ib)[V], int q, int T_len, float (&last)[V],
                                     float (&o)[V], float (&e)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float uo = 0.f, ue = 0.f;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      uo = fmaf(tp.odd[i], w[5 - i][v], uo);
      ue = fmaf(tp.even[i], w[5 - i][v], ue);
    }
    o[v] = snake<FAST>(uo, al[v], ib[v]);
    e[v] = snake<FAST>(ue, al[v], ib[v]);
    if (EDGE) {
      o[v] = q >= T_len ? last[v] : o[v];
      e[v] = q >= T_len - 1 ? o[v] : e[v];
      last[v] = o[v];
    }
  }
}

// One lane's segment: outputs t0 .. t0 + SEG - 1 of V channels (xc, yc at channel c0
// of the lane's batch row). EDGE: the segment reads past a row's edge.
template <typename T, bool FAST, int V, int SEG, bool EDGE>
__device__ __forceinline__ void walk(const T* xc, T* yc, int C, int T_len, int t0, const Taps& tp,
                                     const float (&al)[V], const float (&ib)[V], const float (&bs)[V]) {
  float w[6][V];   // x'[q-2 .. q+3] of the newest pair q
  float a[12][V];  // a[2t-5 .. 2t+6] for the next output t
  float last[V];
#pragma unroll
  for (int v = 0; v < V; ++v) last[v] = 0.f;
#pragma unroll
  for (int i = 0; i < 5; ++i) load<T, V, EDGE>(xc, t0 - 5 + i, C, T_len, bs, w[i + 1]);
#pragma unroll
  for (int k = 0; k < 6; ++k) {  // pairs q = t0 - 3 .. t0 + 2
#pragma unroll
    for (int i = 0; i < 5; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v) w[i][v] = w[i + 1][v];
    load<T, V, EDGE>(xc, t0 + k, C, T_len, bs, w[5]);
    pair<FAST, V, EDGE>(w, tp, al, ib, t0 - 3 + k, T_len, last, a[2 * k], a[2 * k + 1]);
  }
  if (EDGE && t0 == 0) {  // a[n] for n < 0 (slots 0-4) is a[0] (slot 5)
#pragma unroll
    for (int j = 0; j < 5; ++j)
#pragma unroll
      for (int v = 0; v < V; ++v) a[j][v] = a[5][v];
  }
#pragma unroll
  for (int k = 0; k < SEG; ++k) {
    const int t = t0 + k;
    Vec<T, V> out;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < 12; ++j) acc = fmaf(tp.down[j], a[j][v], acc);
      out.v[v] = port::from_f<T>(acc);
    }
    if (!EDGE || t < T_len) *reinterpret_cast<Vec<T, V>*>(yc + (long long)t * C) = out;
    if (k + 1 < SEG) {  // the next output's pair q = t + 3, from x'[t+1 .. t+6]
#pragma unroll
      for (int j = 0; j < 10; ++j)
#pragma unroll
        for (int v = 0; v < V; ++v) a[j][v] = a[j + 2][v];
#pragma unroll
      for (int i = 0; i < 5; ++i)
#pragma unroll
        for (int v = 0; v < V; ++v) w[i][v] = w[i + 1][v];
      load<T, V, EDGE>(xc, t + 6, C, T_len, bs, w[5]);
      pair<FAST, V, EDGE>(w, tp, al, ib, t + 3, T_len, last, a[10], a[11]);
    }
  }
}

// Lane l: channel group l % (C / V), then segment, then batch row.
template <typename T, bool FAST, int V, int SEG>
__global__ void __launch_bounds__(THREADS)
    snake_aa_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ alpha,
                    const float* __restrict__ inv_beta, const float* __restrict__ bias, Taps taps,
                    int C, int T_len, int groups, int segs, long long lanes) {
  const long long lane = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= lanes) return;
  const int c0 = (int)(lane % groups) * V;
  const long long rest = lane / groups;
  const int t0 = (int)(rest % segs) * SEG;
  const long long base = (rest / segs) * (long long)T_len * C + c0;
  float al[V], ib[V], bs[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    al[v] = alpha[c0 + v];
    ib[v] = inv_beta[c0 + v];
    bs[v] = bias != nullptr ? bias[c0 + v] : 0.f;
  }
  // Interior: every load from x[t0-5 .. t0+SEG+4] lies in the row.
  if (t0 >= 5 && t0 + SEG + 5 <= T_len) {
    walk<T, FAST, V, SEG, false>(x + base, y + base, C, T_len, t0, taps, al, ib, bs);
  } else {
    walk<T, FAST, V, SEG, true>(x + base, y + base, C, T_len, t0, taps, al, ib, bs);
  }
}

template <typename T, bool FAST, int V, int SEG>
int launch(const void* x, void* y, const float* alpha, const float* inv_beta, const float* bias,
           const Taps& taps, int B, int C, int T_len, cudaStream_t stream) {
  const int groups = C / V, segs = (T_len + SEG - 1) / SEG;
  const long long lanes = (long long)B * segs * groups;
  const long long blocks = (lanes + THREADS - 1) / THREADS;
  snake_aa_kernel<T, FAST, V, SEG><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const T*)x, (T*)y, alpha, inv_beta, bias, taps, C, T_len, groups, segs, lanes);
  PORT_RETURN_IF_ERROR();
  return 0;
}

// The (channels a lane, outputs a lane) pairs built: the wrapper's plan and the
// chip smoke's sweep pick among them. At the published stages (bf16, H100) 2 x 16
// was the fastest or within 5% of it; 2 x 8, 4 x 8 and 4 x 32 were 5-50% slower and
// are not built (4 channels take 104-128 registers a lane, 2 take 63).
template <typename T, bool FAST>
int dispatch(int vec, int seg, const void* x, void* y, const float* alpha, const float* inv_beta,
             const float* bias, const Taps& taps, int B, int C, int T_len, cudaStream_t s) {
#define SNAKE_AA_CASE(V_, S_) \
  if (vec == V_ && seg == S_) return launch<T, FAST, V_, S_>(x, y, alpha, inv_beta, bias, taps, B, C, T_len, s);
  SNAKE_AA_CASE(1, 16)
  SNAKE_AA_CASE(2, 16)
  SNAKE_AA_CASE(2, 32)
  SNAKE_AA_CASE(4, 16)
#undef SNAKE_AA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (x and y, [B, T, C] contiguous, each V-aligned;
// alpha, inv_beta and the optional bias [C] float32 on the device, bias null for
// none; the 12 taps float32 in host memory). vec channels a lane (dividing C) and
// seg outputs a lane, one of the pairs `dispatch` built. Returns a cudaError_t code.
extern "C" int snake_aa_forward(int dtype, int B, int C, int T, int vec, int seg, const void* x, void* y,
                                const void* alpha, const void* inv_beta, const void* bias, const void* taps,
                                void* stream) {
  if (B <= 0 || C <= 0 || T <= 0 || vec <= 0 || C % vec != 0) return (int)cudaErrorInvalidValue;
  const float* f = (const float*)taps;
  Taps tp;
  for (int i = 0; i < 6; ++i) {
    tp.odd[i] = 2.f * f[2 * i];
    tp.even[i] = 2.f * f[2 * i + 1];
  }
  for (int j = 0; j < 12; ++j) tp.down[j] = f[j];
  auto s = (cudaStream_t)stream;
  auto a = (const float*)alpha, ib = (const float*)inv_beta, b = (const float*)bias;
  if (dtype == 0) return dispatch<float, false>(vec, seg, x, y, a, ib, b, tp, B, C, T, s);
  if (dtype == 1) return dispatch<__nv_bfloat16, true>(vec, seg, x, y, a, ib, b, tp, B, C, T, s);
  return (int)cudaErrorInvalidValue;
}
