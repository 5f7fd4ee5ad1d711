// bf16 tensor-core GEMM for Hopper (sm_90a), shared by the transformer stack, the
// Vocos stack and the single ConvNeXt block: C[M, N] = epilogue(A'[M, K] @ W[K, N])
// with the A modes, the epilogues and the rounding points of port::gemm (common.cuh),
// which stays the float32 path. C and the residual are bf16, or float32 where the
// single block's activation is (the rounding to the output type is then exact).
//
// Replaces the matrix products inside
// gonova_tts_tpu/ops/transformer_stack_kernel.py::transformer_stack_pallas and
// gonova_tts_tpu/ops/vocos_stack_kernel.py::vocos_stack_pallas (MXU dots on
// VMEM-resident tiles).
//
// What bounds it on the H100: operations. The stacks' products are small
// (M = B*T from 64 to 8192 rows, N from 256 to 1536, K from 256 to 3072), so the
// tensor cores are only reached if (a) operands arrive without the threads
// spending instructions on them and (b) enough blocks exist to cover 132 SMs.
// What this design does about it:
//   * wgmma.mma_async m64nNk16 (bf16 x bf16 -> f32 registers), both operands
//     read from shared memory in the 128-byte-swizzled K-major layout. BK = 64:
//     one swizzle row is 64 bf16.
//   * A ring of 3 or 4 (A tile, W tile) pairs in dynamic shared memory, filled by
//     TMA (cp.async.bulk.tensor, completion counted on an mbarrier) from one
//     producer warp; one or two consumer warpgroups (64 rows each) run wgmma on
//     the stages that have arrived and hand them back through a second mbarrier.
//     One wgmma group stays in flight while the next stage is awaited. The ring is
//     four deep for the 64-row tiles (16 or 24 KB a stage) and three deep for the
//     128 x 128 tile (32 KB a stage), so that two or three blocks share an SM and one
//     block's epilogue overlaps another's products: the K loops here are short (4 to
//     48 stages), so a block's start and end are a large part of its life.
//   * A is described to TMA as [B, T, Cin]; the grid runs over (N tiles, T tiles,
//     B x split). Tap j of the k=3 conv loads the tile at row t0 + j - 1: rows
//     before 0 and past T are out of bounds and arrive as zeros, which is the
//     conv's zero edge, and no tile spans two sequences. Ragged T is the same
//     mechanism; the epilogue masks its stores. A_ROWS is the same kernel with
//     one tap and the rows taken as one sequence of length M.
//   * W is read transposed, Wt[N, K] (K contiguous), so that both operands are
//     K-major: pack_params stores that copy for bf16.
//   * Tile (64 x 64, 64 x 128 or 128 x 128) and K split are chosen on the host,
//     in Python (ops/gemm_tc.py::plan), from a sweep of every tile and split at the
//     serving products (ops/gemm_tc_sweep.py): 64 x 128 unless 128 x 128 still gives
//     two blocks an SM. The split depends on (N, K) only, never on B or T, and its
//     partial sums go to an f32 workspace that a second pass adds in split order:
//     an output row is summed in the same order at every dispatch shape, and no
//     floating-point atomics are used.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder itself is reached through the runtime

#include "common.cuh"

namespace port {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int TC_BK = 64;      // K elements per stage: 128 bytes of bf16
constexpr int EPI_PARTIAL = -1;  // split-K: raw f32 partial sums to the workspace

// ------------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile whose rows are 128 bytes
// (64 bf16), 128-byte swizzled, 1024-byte aligned: 8-row groups 1024 bytes apart
// (SBO), the leading offset unused by swizzled K-major layouts. A step of 16 in K
// is 32 bytes further along the row: +2 in the (address >> 4) field.
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  uint64_t d = (uint64_t)((smem_u32(tile) & 0x3FFFFu) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;  // SWIZZLE_128B
  return d;
}

// D[64 x 64] += A[64 x 16] * B[64 x 16]^T, both operands K-major in 128B-swizzled shared memory.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[128 x 16]^T, both operands K-major in 128B-swizzled shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int BN> struct Wgmma;
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) { wgmma_m64n64k16(d, a, b); }
};
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) { wgmma_m64n128k16(d, a, b); }
};

// ------------------------------------------------------------------ epilogue

// v = acc + bias[n] in f32; r = resid[m, n]; the rounding points of common.cuh, to the
// output type TO (bf16, or float, where the rounding is the identity). common.cuh's
// EPI_GELU_F32 is EPI_GELU in a kernel compiled with F32_GELU, chosen by the caller of
// gemm_tc: a sixth case in this runtime switch changed how the unrolled epilogue
// compiled, and every unsplit product of the stacks took ~4 us more on the H100
// (chip_smoke.py's `gemm case` lines).
template <typename TO, bool F32_GELU>
__device__ __forceinline__ float apply_epilogue(int epi, float v, float r, float mask_m, float gamma_n) {
  switch (epi) {
    case EPI_BIAS: return v;
    case EPI_BIAS_RELU: return fmaxf(v, 0.f);
    case EPI_RESID_MASK: return rnd<TO>(r + rnd<TO>(v)) * mask_m;
    case EPI_GELU: return gelu_tanh(F32_GELU ? v : rnd<TO>(v));
    default: return r + rnd<TO>(v * gamma_n);  // EPI_GAMMA_RESID
  }
}

// C and resid are TO [M, N]; everything else as for bf16.
template <typename TO>
struct Params {
  TO* C;                 // [M, N]
  const TO* resid;       // [M, N] or null; may alias C
  const float* bias;     // [N]
  const float* mask;     // [M] or null
  const float* gamma;    // [N] or null
  float* ws;             // [split, M, N] f32 when split > 1
  int M, N, T_len, Cin, taps, split, epi;
};

// Two adjacent elements (n, n + 1) of a TO row: loaded raw, widened to f32, stored
// rounded to nearest even.
template <typename TO> struct Pair;
template <> struct Pair<bf16> {
  using raw = uint32_t;
  static __device__ __forceinline__ raw load(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }
  static __device__ __forceinline__ float2 widen(raw r) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&r);
    return make_float2(__bfloat162float(v.x), __bfloat162float(v.y));
  }
  static __device__ __forceinline__ void store(bf16* p, float2 v) {
    __nv_bfloat162 out;
    out.x = __float2bfloat16_rn(v.x);
    out.y = __float2bfloat16_rn(v.y);
    *reinterpret_cast<__nv_bfloat162*>(p) = out;
  }
};
template <> struct Pair<float> {
  using raw = float2;
  static __device__ __forceinline__ raw load(const float* p) { return *reinterpret_cast<const float2*>(p); }
  static __device__ __forceinline__ float2 widen(raw r) { return r; }
  static __device__ __forceinline__ void store(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }
};

// Two adjacent outputs (m, n) and (m, n + 1), n even, from their f32 sums a, the
// bias pair b, resid's raw pair r, the row's mask value and the gamma pair g: the
// epilogue, stored to p.
template <typename TO, bool F32_GELU>
__device__ __forceinline__ void finish_pair(TO* p, int epi, float2 a, float2 b, typename Pair<TO>::raw r, float mk,
                                            float2 g) {
  const float2 rr = Pair<TO>::widen(r);
  Pair<TO>::store(p, make_float2(apply_epilogue<TO, F32_GELU>(epi, a.x + b.x, rr.x, mk, g.x),
                                 apply_epilogue<TO, F32_GELU>(epi, a.y + b.y, rr.y, mk, g.y)));
}

// ------------------------------------------------------------------ the kernel

// Block: WGS consumer warpgroups (warps 0 .. 4*WGS-1, 64 output rows each) and one
// producer warp. Output tile (64*WGS) x BN at rows t0.. of sequence b, columns n0..;
// K iterations [it0, it1) of this block's split.
template <typename TO, bool F32_GELU, int WGS, int BN, int TC_STAGES>
__global__ void __launch_bounds__(WGS * 128 + 32, WGS == 2 ? 2 : 1)  // 128 x 128: two blocks an SM
gemm_tc_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
               const Params<TO> p) {
  constexpr int BM = 64 * WGS;
  constexpr int A_BYTES = BM * TC_BK * 2, W_BYTES = BN * TC_BK * 2;
  extern __shared__ uint8_t smem_raw[];
  // The swizzle is a function of the address: tiles start on 1024-byte lines.
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TC_STAGES * (A_BYTES + W_BYTES));
  uint64_t* empty = full + TC_STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * BN, t0 = blockIdx.y * BM;
  const int b = blockIdx.z / p.split, ks = blockIdx.z % p.split;
  const int chunks_per_tap = p.Cin / TC_BK;
  const int iters = p.taps * chunks_per_tap / p.split;
  const int it0 = ks * iters;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WGS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WGS * 4) {
    // Producer: one thread keeps the ring full.
    if (lane == 0) {
      for (int i = 0; i < iters; ++i) {
        const int s = i % TC_STAGES, round = i / TC_STAGES;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        const int it = it0 + i;
        const int tap = it / chunks_per_tap, c0 = (it - tap * chunks_per_tap) * TC_BK;
        const int row = t0 + (p.taps == 3 ? tap - 1 : 0);
        uint8_t* stage = smem + s * (A_BYTES + W_BYTES);
        mbar_arrive_expect_tx(&full[s], A_BYTES + W_BYTES);
        tma_load_3d(stage, &map_a, &full[s], c0, row, b);
        tma_load_2d(stage + A_BYTES, &map_w, &full[s], it * TC_BK, n0);
      }
    }
    return;
  }

  // Consumers.
  const int wg = warp >> 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int i = 0; i < iters; ++i) {
    const int s = i % TC_STAGES, round = i / TC_STAGES;
    mbar_wait(&full[s], round & 1);
    const uint8_t* stage = smem + s * (A_BYTES + W_BYTES);
    const uint64_t da = smem_desc(stage + wg * 64 * TC_BK * 2);
    const uint64_t dw = smem_desc(stage + A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) Wgmma<BN>::run(acc, da + 2 * kk, dw + 2 * kk);
    wgmma_commit();
    if (i > 0) {
      // The previous stage's products have finished: hand its buffers back.
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(&empty[(i - 1) % TC_STAGES]);
    }
  }
  wgmma_wait<0>();

  // Accumulator layout of m64nNk16: thread (warp w of the group, lane l) holds rows
  // 16w + l/4 and 16w + l/4 + 8, columns 8j + 2(l%4) and + 1 for j = 0 .. BN/8 - 1,
  // as acc[4j + 0, 1] (first row) and acc[4j + 2, 3] (second row).
  //
  // resid may alias C, so no load may move across a store, and a loop of (load bias,
  // load resid, store) pairs is a chain of memory latencies, one a pair: measured, it
  // was most of a small product's time. So the loads of EPI_BATCH column groups are
  // issued together, at clamped addresses and without branches, and only then the
  // stores: one latency a batch.
  constexpr int EPI_BATCH = WGS == 2 ? 4 : 8;  // 128 x 128 keeps to the registers of two blocks an SM
  const int epi = p.split > 1 ? EPI_PARTIAL : p.epi;
  const bool has_resid = epi == EPI_RESID_MASK || epi == EPI_GAMMA_RESID;
  const int row0 = t0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int col0 = n0 + (lane & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = row0 + half * 8;
    if (t >= p.T_len) continue;
    const int m = b * p.T_len + t;
    if (epi == EPI_PARTIAL) {
      float* wrow = p.ws + ((size_t)ks * p.M + m) * p.N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = col0 + j * 8;
        if (n < p.N) *reinterpret_cast<float2*>(wrow + n) = make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
      continue;
    }
    const float mk = epi == EPI_RESID_MASK ? p.mask[m] : 0.f;
    const TO* rrow = has_resid ? p.resid + (size_t)m * p.N : p.C;  // never read when !has_resid
    TO* crow = p.C + (size_t)m * p.N;
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += EPI_BATCH) {
      float2 bv[EPI_BATCH], gv[EPI_BATCH];
      typename Pair<TO>::raw rv[EPI_BATCH];
#pragma unroll
      for (int u = 0; u < EPI_BATCH; ++u) {
        const int n = min(col0 + (j0 + u) * 8, p.N - 2);
        bv[u] = *reinterpret_cast<const float2*>(p.bias + n);
        gv[u] = epi == EPI_GAMMA_RESID ? *reinterpret_cast<const float2*>(p.gamma + n) : make_float2(0.f, 0.f);
        rv[u] = has_resid ? Pair<TO>::load(rrow + n) : typename Pair<TO>::raw{};
      }
#pragma unroll
      for (int u = 0; u < EPI_BATCH; ++u) {
        const int j = j0 + u, n = col0 + j * 8;
        const float2 a = make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
        if (n < p.N) finish_pair<TO, F32_GELU>(crow + n, epi, a, bv[u], rv[u], mk, gv[u]);
      }
    }
  }
}

// Second pass of a split product: the partial sums added in split order, then the
// epilogue. One thread per pair of adjacent columns.
template <typename TO, bool F32_GELU>
__global__ void splitk_epilogue_kernel(const Params<TO> p) {
  const size_t pair = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)p.M * p.N;
  if (2 * pair >= total) return;
  const int m = (int)((2 * pair) / p.N), n = (int)((2 * pair) % p.N);
  float2 sum = *reinterpret_cast<const float2*>(p.ws + 2 * pair);
  for (int z = 1; z < p.split; ++z) {
    const float2 v = *reinterpret_cast<const float2*>(p.ws + (size_t)z * total + 2 * pair);
    sum.x += v.x;
    sum.y += v.y;
  }
  const size_t o = (size_t)m * p.N + n;
  const bool has_resid = p.epi == EPI_RESID_MASK || p.epi == EPI_GAMMA_RESID;
  const typename Pair<TO>::raw r = has_resid ? Pair<TO>::load(p.resid + o) : typename Pair<TO>::raw{};
  const float mk = p.epi == EPI_RESID_MASK ? p.mask[m] : 0.f;
  const float2 g = p.epi == EPI_GAMMA_RESID ? *reinterpret_cast<const float2*>(p.gamma + n) : make_float2(0.f, 0.f);
  finish_pair<TO, F32_GELU>(p.C + o, p.epi, sum, *reinterpret_cast<const float2*>(p.bias + n), r, mk, g);
}

// ------------------------------------------------------------------ host side

typedef CUresult (*TensorMapEncodeFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                      CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so that nothing links against libcuda.
inline TensorMapEncodeFn tensor_map_encoder() {
  static TensorMapEncodeFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) f = nullptr;
    return reinterpret_cast<TensorMapEncodeFn>(f);
  }();
  return fn;
}

// A bf16 tensor [d2, d1, d0] (d0 contiguous) cut into boxes [1, box1, 64] that land
// in shared memory 128-byte swizzled; elements out of bounds arrive as zeros.
inline bool encode_map(CUtensorMap* map, const void* base, int rank, uint64_t d0, uint64_t d1, uint64_t d2,
                       uint32_t box1) {
  TensorMapEncodeFn enc = tensor_map_encoder();
  if (!enc) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {(cuuint32_t)TC_BK, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One product's tile and split, chosen in Python (ops/gemm_tc.py::plan).
struct Plan {
  int wgs, bn, split;
};

// Internal linkage: each library that includes this header has its own copy of the
// kernels, and so needs its own opted_in (a static of an inline function would be
// one symbol for the whole process). The opt-in is an attribute of the kernel on the
// current device only, so it is kept per device: bit d for device d.
namespace {
template <typename TO, bool F32_GELU, int WGS, int BN>
int launch(const CUtensorMap& map_a, const CUtensorMap& map_w, const Params<TO>& p, int B, cudaStream_t s) {
  constexpr int BM = 64 * WGS;
  constexpr int TC_STAGES = (BM + BN) * TC_BK * 2 > 24 * 1024 ? 3 : 4;
  constexpr int SMEM = TC_STAGES * (BM + BN) * TC_BK * 2 + 2 * TC_STAGES * 8 + 1024;
  static uint64_t opted_in = 0;
  int dev = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!(opted_in >> dev & 1)) {
    cudaFuncSetAttribute(gemm_tc_kernel<TO, F32_GELU, WGS, BN, TC_STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM);
    PORT_RETURN_IF_ERROR();
    opted_in |= uint64_t(1) << dev;
  }
  dim3 grid((p.N + BN - 1) / BN, (p.T_len + BM - 1) / BM, B * p.split);
  gemm_tc_kernel<TO, F32_GELU, WGS, BN, TC_STAGES><<<grid, WGS * 128 + 32, SMEM, s>>>(map_a, map_w, p);
  PORT_RETURN_IF_ERROR();
  return 0;
}

// The tile's kernel, then a split product's second pass.
template <typename TO, bool F32_GELU>
int run(const CUtensorMap& map_a, const CUtensorMap& map_w, const Params<TO>& p, Plan plan, int B, cudaStream_t s) {
  int rc;
  if (plan.wgs == 1 && plan.bn == 64) rc = launch<TO, F32_GELU, 1, 64>(map_a, map_w, p, B, s);
  else if (plan.wgs == 1 && plan.bn == 128) rc = launch<TO, F32_GELU, 1, 128>(map_a, map_w, p, B, s);
  else if (plan.wgs == 2 && plan.bn == 128) rc = launch<TO, F32_GELU, 2, 128>(map_a, map_w, p, B, s);
  else return (int)cudaErrorInvalidConfiguration;
  if (rc) return rc;
  if (p.split > 1) {
    const size_t pairs = (size_t)p.M * p.N / 2;
    splitk_epilogue_kernel<TO, F32_GELU><<<(unsigned)((pairs + 255) / 256), 256, 0, s>>>(p);
    PORT_RETURN_IF_ERROR();
  }
  return 0;
}
}  // namespace

// C = epilogue(A' @ Wt^T). A [B, T_len, Cin] bf16 (taps == 1: A' = A; taps == 3: the
// k=3 SAME conv's implicit im2col, K = 3 * Cin), Wt [N, taps * Cin] bf16, C and
// resid [B * T_len, N] in TO (bf16 or float), ws f32 [split, B * T_len, N] when
// plan.split > 1. epi is EPI_BIAS .. EPI_GAMMA_RESID; with F32_GELU, EPI_GELU takes the
// GELU of the f32 sum (EPI_GELU_F32). Needs Cin % 64 == 0, N % 8 == 0,
// (taps * Cin / 64) % split == 0: the Python wrapper checks and raises. Returns a
// cudaError_t code.
template <typename TO, bool F32_GELU = false>
inline int gemm_tc(const bf16* A, const bf16* Wt, TO* C, int B, int T_len, int Cin, int taps, int N, int epi,
                   const float* bias, const typename same_type<TO>::type* resid, const float* mask,
                   const float* gamma, float* ws, Plan plan, cudaStream_t s) {
  const int K = taps * Cin;
  if (Cin % TC_BK || N % 8 || plan.split < 1 || (K / TC_BK) % plan.split || (taps != 1 && taps != 3) ||
      epi < EPI_BIAS || epi > EPI_GAMMA_RESID)
    return (int)cudaErrorInvalidValue;
  Params<TO> p;
  p.C = C; p.resid = resid; p.bias = bias; p.mask = mask; p.gamma = gamma; p.ws = ws;
  p.M = B * T_len; p.N = N; p.T_len = T_len; p.Cin = Cin; p.taps = taps; p.split = plan.split; p.epi = epi;
  const int bm = 64 * plan.wgs;
  CUtensorMap map_a, map_w;
  // A tensor map that cuTensorMapEncodeTiled refuses is reported as an invalid pitch
  // (A) or an invalid texture (W), an unknown tile as an invalid configuration.
  if (!encode_map(&map_a, A, 3, (uint64_t)Cin, (uint64_t)T_len, (uint64_t)B, (uint32_t)bm))
    return (int)cudaErrorInvalidPitchValue;
  if (!encode_map(&map_w, Wt, 2, (uint64_t)K, (uint64_t)N, 1, (uint32_t)plan.bn))
    return (int)cudaErrorInvalidTexture;
  return run<TO, F32_GELU>(map_a, map_w, p, plan, B, s);
}

}  // namespace tc
}  // namespace port
