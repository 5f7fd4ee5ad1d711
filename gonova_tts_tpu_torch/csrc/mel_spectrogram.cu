// Log-mel spectrogram for Hopper (sm_90a), one launch:
//   reflect-padded audio -> framed DFT with the Hann window folded into the cos/sin
//   bases -> sqrt(max(re^2 + im^2, 1e-9)) -> slaney filterbank -> log(max(., eps))
//
// Replaces gonova_tts_tpu/ops/mel_kernel.py::mel_spectrogram_pallas. The Pallas
// kernel DMAs a block of hop-rows into VMEM and adds n_fft / hop row-shifted MXU
// products at Precision.HIGHEST (a multi-pass bf16 emulation of f32).
//
// What bounds it on the H100: operations, 2 * 2 * n_fft * n_bins + 2 * n_bins * n_mels
// per frame (~2.2 MFLOP) against ~1 KB of new audio. The products must keep f32-grade
// accuracy (the log near the eps floor amplifies input error), so their ceiling here
// is split TF32 on the tensor cores: x = hi + lo with hi = TF32(x), lo = TF32(x - hi),
// and re/im = A_lo B_hi + A_hi B_lo + A_hi B_hi with f32 accumulation, three TF32
// products (495 / 3 = 165 TFLOP/s) with an error near f32 FMA's.
//
// What the design does:
//   * Grid (frame tile, sequence): a tile is 64 frames of one sequence and starts at
//     a multiple of 64, so a row's bits depend neither on B nor on where it lies.
//     Each tile is a thread-block cluster of 8 blocks; block r owns 72 bins (576 in
//     all; for n_fft = 1024 the Nyquist bin 512 is the last block's ragged edge).
//   * The tile's audio, (64 - 1) * hop + n_fft samples, is copied once into shared
//     memory as hop-rows with a pitch of hop + 4 floats, so the A fragments of 8
//     consecutive frames fall in distinct banks. The reflect pad (and the short-clip
//     zero extension) is done in the source index of each element's cp.async: no
//     padded copy exists in device memory. (cp.async.bulk would need 16-byte aligned
//     rows; a row starts at tile * 64 * hop - (n_fft - hop) / 2 of any T.)
//   * The bases are split into hi/lo on the host and stored as the shared-memory image
//     wgmma reads: per 32-deep K tile and block, [cos|sin][hi|lo] tiles of [72 bins][32 k]
//     TF32, K-major, 128-byte swizzled, one contiguous 36 KB stage each. They stream
//     through a 3-stage ring, one bulk copy (cp.async.bulk) a stage, completion counted
//     on an mbarrier.
//   * Two warpgroups, cos and sin: wgmma m64n72k8 TF32 with A (the frames) from
//     registers, split there with cvt.rna, and B from the ring; three products a K
//     step, twelve a K tile. While a tile's products run, the previous tile's are
//     waited for (wgmma.wait_group 1), its slot refilled, and the next tile's A split
//     into a second register set. Every output is summed over k in the same order.
//     (mma.sync m16n8k8 came first and was slower: each warp re-read its B fragments
//     from shared memory.)
//   * Epilogue in shared memory: mag for the block's bins, then the block's partial
//     mel over the bands whose nonzero bins (ranges from the host) meet them, in f32
//     FMA from the block's rows of the filterbank, staged with the audio; the 8
//     partial mels are added through distributed shared memory in rank order (no
//     atomics: two calls give the same bits), each block finishing 8 frames:
//     log(max(., eps)) and one contiguous run of stores. No magnitude buffer in device
//     memory; the wrapper allocates only the output.
#include <cooperative_groups.h>

#include "gemm_tc.cuh"

namespace cg = cooperative_groups;

namespace port {
namespace mel {

constexpr int G = 8;        // blocks in a cluster: bin groups of one frame tile
constexpr int FT = 64;      // frames per tile
constexpr int NB = 72;      // bins a block
constexpr int KT = 32;      // K per ring stage: one 128-byte swizzle row of TF32
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int TILE_BYTES = NB * KT * 4;      // [72 bins][32 k] TF32
constexpr int STAGE_BYTES = 4 * TILE_BYTES;  // cos hi, cos lo, sin hi, sin lo
constexpr int RING_BYTES = STAGES * STAGE_BYTES;

struct Params {
  const float* x;       // [B, T] unpadded audio
  const uint8_t* bases; // [G][n_fft / KT] stages of STAGE_BYTES
  const float* fb;      // [n_bins, n_mels]
  const int* band;      // [2, n_mels]: each band's nonzero bins [lo, hi)
  float* out;           // [B, n_frames, n_mels]
  int T, n_frames, hop, n_fft, n_bins, n_mels, rows, pitch, region0;
  float eps;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(tc::smem_u32(dst)), "l"(src) : "memory");
}

// One contiguous copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to this block's shared memory, completion counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(tc::smem_u32(dst)), "l"(src), "r"(bytes), "r"(tc::smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v rounded to TF32 (nearest, ties away from zero), the low 13 bits cleared.
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xFFFFE000u;
}

// D[64 x 72] += A[64 x 8] * B[72 x 8]^T in TF32: A from registers (the m16n8k8 A
// fragment of each warp's 16 rows), B K-major in 128B-swizzled shared memory.
__device__ __forceinline__ void wgmma_m64n72k8_tf32(float (&d)[36], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The unpadded sample that padded position p reads, or -1 for a zero: reflection
// about both ends of a clip zero-extended to pad + 1 samples when it is shorter
// (audio/stft.py::reflect_pad; ops/mel_spectrogram.py::reflect_source is the twin).
__device__ __forceinline__ int reflect_source(int p, int T, int pad) {
  const int te = max(T, pad + 1);
  int i = abs(p - pad);
  if (i >= te) i = 2 * te - 2 - i;
  return i < T ? i : -1;
}

__global__ void __cluster_dims__(G, 1, 1) __launch_bounds__(THREADS, 1) mel_kernel(const Params p) {
  extern __shared__ uint8_t smem_raw[];
  // The swizzle is a function of the address: the ring starts on a 1024-byte line.
  uint8_t* ring = smem_raw + ((1024u - (tc::smem_u32(smem_raw) & 1023u)) & 1023u);
  float* aud = reinterpret_cast<float*>(ring + RING_BYTES);  // [rows][pitch], later the partial mels
  float* fbs = aud + p.region0;                               // [NB][n_mels]: this block's rows of fb
  int* band = reinterpret_cast<int*>(fbs + NB * p.n_mels);    // [2][n_mels]
  __shared__ uint64_t full[STAGES];  // stage s has landed (phase = round & 1)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int f0 = (blockIdx.x / G) * FT, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = rank * NB;
  const int n_kt = p.n_fft / KT;
  const uint8_t* bases = p.bases + (size_t)rank * n_kt * STAGE_BYTES;

  // The tile's audio, once. Positions past the last frame's end are never read
  // by a valid frame and are zero. Then this block's filterbank rows and the bands.
  const int pad = (p.n_fft - p.hop) / 2;
  const int p_end = (p.n_frames - 1) * p.hop + p.n_fft;
  const float* xb = p.x + (size_t)b * p.T;
  for (int s = tid; s < p.rows * p.hop; s += THREADS) {
    const int r = s / p.hop, pos = f0 * p.hop + s;
    const int i = pos < p_end ? reflect_source(pos, p.T, pad) : -1;
    float* dst = aud + r * p.pitch + (s - r * p.hop);
    if (i >= 0) cp_async4(dst, xb + i);
    else *dst = 0.f;
  }
  for (int e = tid; e < NB * p.n_mels; e += THREADS) {
    if (q0 + e / p.n_mels < p.n_bins) cp_async4(fbs + e, p.fb + (size_t)q0 * p.n_mels + e);
    else fbs[e] = 0.f;
  }
  for (int e = tid; e < 2 * p.n_mels; e += THREADS) band[e] = __ldg(p.band + e);
  cp_async_commit();
  auto load_stage = [&](int kt) {  // by thread 0 alone
    if (kt < n_kt) {
      tc::mbar_arrive_expect_tx(&full[kt % STAGES], STAGE_BYTES);
      bulk_load(ring + (kt % STAGES) * STAGE_BYTES, bases + (size_t)kt * STAGE_BYTES, STAGE_BYTES, &full[kt % STAGES]);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) tc::mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < STAGES; ++s) load_stage(s);
  }
  cp_async_wait<0>();
  __syncthreads();  // the audio, the filterbank rows and the barriers are ready

  const int part = warp >> 2, w4 = warp & 3;  // warpgroup 0: cos (re), 1: sin (im); frames 16 w4 ..
  float acc[36];
#pragma unroll
  for (int i = 0; i < 36; ++i) acc[i] = 0.f;
  const float* arow = aud + (w4 * 16 + g) * p.pitch + t;

  // The frames' K tile kt, split: A of the four K steps, as wgmma reads it from registers.
  auto split_a = [&](int kt, uint32_t (&ahi)[KT / 8][4], uint32_t (&alo)[KT / 8][4]) {
#pragma unroll
    for (int ks = 0; ks < KT / 8; ++ks) {
      const int kb = kt * KT + ks * 8;  // 8 samples of one hop-row: hop % 8 == 0
      const int ro = kb / p.hop;
      const float* a = arow + ro * p.pitch + (kb - ro * p.hop);
      const float av[4] = {a[0], a[8 * p.pitch], a[4], a[8 * p.pitch + 4]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ahi[ks][i] = tf32(av[i]);
        alo[ks][i] = tf32(__fsub_rn(av[i], __uint_as_float(ahi[ks][i])));
      }
    }
  };
  // K tile kt: its twelve products go out, and while they run the previous tile's are
  // waited for, its ring slot refilled, and the next tile's A split into the other
  // register set (wgmma reads A from registers until it completes).
  auto step = [&](int kt, uint32_t (&ahi)[KT / 8][4], uint32_t (&alo)[KT / 8][4],
                  uint32_t (&nhi)[KT / 8][4], uint32_t (&nlo)[KT / 8][4]) {
    const uint8_t* st = ring + (kt % STAGES) * STAGE_BYTES + part * 2 * TILE_BYTES;
    const uint64_t d_hi = tc::smem_desc(st), d_lo = tc::smem_desc(st + TILE_BYTES);
    tc::mbar_wait(&full[kt % STAGES], (kt / STAGES) & 1);
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KT / 8; ++ks) {  // a K step of 8 TF32 is 32 bytes: +2 in the descriptor
      wgmma_m64n72k8_tf32(acc, alo[ks], d_hi + 2 * ks);
      wgmma_m64n72k8_tf32(acc, ahi[ks], d_lo + 2 * ks);
      wgmma_m64n72k8_tf32(acc, ahi[ks], d_hi + 2 * ks);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<1>();  // tile kt - 1's products are done
    __syncthreads();      // in both warpgroups: refill its slot
    if (tid == 0 && kt >= 1) load_stage(kt - 1 + STAGES);
    if (kt + 1 < n_kt) split_a(kt + 1, nhi, nlo);
  };
  uint32_t hi0[KT / 8][4], lo0[KT / 8][4], hi1[KT / 8][4], lo1[KT / 8][4];
  split_a(0, hi0, lo0);
  for (int kt = 0; kt < n_kt; kt += 2) {  // n_kt is even: n_fft % 64 == 0
    step(kt, hi0, lo0, hi1, lo1);
    step(kt + 1, hi1, lo1, hi0, lo0);
  }
  tc::wgmma_wait<0>();
  __syncthreads();

  // mag [FT][NB + 1] over the ring: the cos warpgroup stores re^2, the sin one finishes.
  // Accumulator j holds rows 16 w4 + g (+ 8 for j % 4 >= 2), column 8 (j / 4) + 2t + j % 2.
  constexpr int MP = NB + 1;
  float* mag = reinterpret_cast<float*>(ring);
  for (int phase = 0; phase < 2; ++phase) {
    if (part == phase) {
#pragma unroll
      for (int j = 0; j < 36; ++j) {
        float* o = mag + (w4 * 16 + g + ((j >> 1) & 1) * 8) * MP + (j >> 2) * 8 + 2 * t + (j & 1);
        const float sq = __fmul_rn(acc[j], acc[j]);
        *o = phase == 0 ? sq : sqrtf(fmaxf(__fadd_rn(*o, sq), 1e-9f));
      }
    }
    __syncthreads();
  }

  // The block's partial mel [FT][n_mels] over the audio, a warp per band: zero for the
  // bands whose nonzero bins miss this block's.
  float* part_mel = aud;
  for (int i = tid; i < FT * p.n_mels; i += THREADS) {
    const int m = i / FT, f = i - m * FT;
    const int lo = max(band[m], q0), hi = min(band[p.n_mels + m], q0 + NB);
    float s = 0.f;
    for (int k = lo - q0; k < hi - q0; ++k) s = fmaf(mag[f * MP + k], fbs[k * p.n_mels + m], s);
    part_mel[f * p.n_mels + m] = s;
  }
  cluster.sync();

  // This block's FT / G frames: the partials of ranks 0 .. G-1 added in that order.
  constexpr int FR = FT / G;
  const int f_first = rank * FR;
  for (int i = tid; i < FR * p.n_mels; i += THREADS) {
    const int idx = f_first * p.n_mels + i;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < G; ++q) s += cluster.map_shared_rank(part_mel, q)[idx];
    if (f0 + f_first + i / p.n_mels < p.n_frames)
      p.out[((size_t)b * p.n_frames + f0) * p.n_mels + idx] = logf(fmaxf(s, p.eps));
  }
  cluster.sync();  // no block leaves while another still reads its partial mel
}

}  // namespace mel
}  // namespace port

namespace {
// Dynamic shared memory the kernel is allowed so far, per device: the opt-in is an
// attribute of the kernel on the current device only.
constexpr int MAX_DEVICES = 64;
size_t opted_in[MAX_DEVICES] = {};
}

// x [B, T] float32 audio (unpadded), bases the split-TF32 stage images of
// ops/mel_spectrogram.py::tf32_bases, fb [n_bins, n_mels], band [2, n_mels] int32,
// out [B, n_frames, n_mels]. Needs n_fft % hop == 0, hop % 8 == 0, n_fft % 64 == 0,
// n_bins <= 576. Returns a cudaError_t code.
extern "C" int mel_spectrogram_forward(int B, int T, int n_frames, int hop, int n_fft, int n_bins, int n_mels,
                                       float eps, const void* x, const void* bases, const void* fb,
                                       const void* band, void* out, void* stream) {
  using namespace port::mel;
  if (B <= 0 || n_frames <= 0) return 0;
  if (hop <= 0 || n_fft % hop || hop % 8 || n_fft % (2 * KT) || n_bins > G * NB || n_mels <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = (const float*)x; p.bases = (const uint8_t*)bases; p.fb = (const float*)fb; p.band = (const int*)band;
  p.out = (float*)out; p.T = T; p.n_frames = n_frames; p.hop = hop; p.n_fft = n_fft; p.n_bins = n_bins;
  p.n_mels = n_mels; p.eps = eps;
  p.rows = FT + n_fft / hop - 1;
  p.pitch = hop + 4;
  p.region0 = max(p.rows * p.pitch, FT * n_mels);  // the audio, then the partial mels
  const size_t smem = 1024 + RING_BYTES + sizeof(float) * ((size_t)p.region0 + NB * n_mels + 2 * n_mels);
  if (smem > 232448 - 1024) return (int)cudaErrorInvalidValue;  // 227 KB a block, the barriers beside
  int dev = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > opted_in[dev]) {
    cudaFuncSetAttribute(mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    PORT_RETURN_IF_ERROR();
    opted_in[dev] = smem;
  }
  const dim3 grid(((n_frames + FT - 1) / FT) * G, B);
  mel_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(p);
  PORT_RETURN_IF_ERROR();
  return 0;
}
