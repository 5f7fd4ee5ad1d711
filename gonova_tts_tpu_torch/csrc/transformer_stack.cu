// Acoustic transformer stack for Hopper (sm_90a): L pre-LN blocks and a final LN.
//
// Replaces gonova_tts_tpu/ops/transformer_stack_kernel.py::transformer_stack_pallas
// (one pallas_call with the activation resident in VMEM). Here the host loops over
// the layers and launches, per layer:
//   ln_rows (LN1) -> gemm QKV (+bias) -> attention -> gemm out-proj (+bias,
//   residual, row mask) -> ln_rows (LN2) -> gemm conv-FFN1 as implicit im2col over
//   K = 3*D (+bias, ReLU) -> gemm conv-FFN2 over K = 3*F (+bias, residual, mask)
// and one final ln_rows. Weights use the natural head layout (head h owns columns
// h*dh..h*dh+dh of q, k and v); the Pallas kernel's 128-lane head padding was a
// TPU layout artefact.
//
// What bounds it on the H100: operations. The GEMMs are ~95% of them (at the
// decoder's B=4, T=512: ~11 GFLOP a stack) and attention the rest. What this design
// does about it, in bf16:
//   * every product goes through the tensor-core GEMM of gemm_tc.cuh: wgmma fed by
//     a TMA ring, the conv's im2col and its zero edges done by TMA's out-of-bounds
//     fill, the tile picked per product (ops/gemm_tc.py::plan), and conv-FFN2
//     (K = 3*F, N = D: few output tiles, a long K loop) split in K by a rule of
//     (N, K) alone, its parts added in a fixed order by a second pass;
//   * attention_tc_kernel: one block per (batch, head, 64-query tile), four warps
//     of 16 queries; Q, and each 64-key tile of K and V, come into shared memory
//     once per tile by cp.async (double-buffered: the next tile is on its way
//     while this one is multiplied), and Q.K^T and P.V run on the tensor cores
//     (mma.sync m16n8k16, V fragments by ldmatrix.trans). The softmax is exact and
//     takes two passes over the keys: the first keeps each row's running max and
//     sum, the second recomputes the logits, forms p = exp(l - max) / sum with the
//     final max and sum, rounds p to bf16 (where the Pallas kernel rounds it) and
//     multiplies. That doubles Q.K^T, ~5% of the stack's operations, and needs no
//     T-long row of logits in shared memory. exp is the hardware's ex2 (__expf)
//     and the two divisions are multiplications by reciprocals: there are only
//     B*H*T/16 warps in all, too few on an SM to hide anything, so the count of
//     instructions per logit is what the kernel's time is made of (3.5x measured).
// float32 keeps the CUDA-core GEMM of common.cuh and attention_kernel below, bit
// for bit: the engine's two-stage == one-graph contract is held in f32, off the
// tensor cores. The ~29 launches a stack are the next bound at small shapes.
//
// bf16 mode rounds where the Pallas kernel rounds: qkv, the probabilities p, the
// attention output, h_res, the ReLU output and the stored activation. Logits,
// softmax, LN statistics and all accumulation stay f32.
#include "gemm_tc.cuh"

namespace port {

constexpr int ATT_QT = 8;   // queries per block, one warp each
constexpr int ATT_KC = 64;  // keys staged in shared memory per chunk
constexpr float NEG = -1e9f;

// Attention for one (batch, head, tile of ATT_QT queries). qkv [B*T, 3D] rows hold
// q | k | v; out [B*T, D]. window == 0: every key of the sequence; else keys of the
// query's block and both neighbours ([blk*w - w, blk*w + 2w)), out-of-range keys
// getting logit NEG exactly as the zero-edged blocks of layers.local_mha do. Masked
// keys add NEG. Softmax is exact (max, sum, then p = e / sum) because p is rounded
// to T before the p @ v product, as in the Pallas kernel.
template <typename T>
__global__ void attention_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                                 const float* __restrict__ mask, int Tn, int D, int H,
                                 int window, float sqrt_dh) {
  extern __shared__ __align__(16) float smem[];
  const int dh = D / H;
  const int q0 = blockIdx.x * ATT_QT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int span = window > 0 ? 3 * window : Tn;
  const int ks0 = window > 0 ? (q0 / window) * window - window : 0;
  float* qs = smem;                      // [ATT_QT][dh]
  float* kv = qs + ATT_QT * dh;          // [ATT_KC][dh + 1]
  float* lg = kv + ATT_KC * (dh + 1);    // [ATT_QT][span]
  const size_t rs = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * Tn * rs;

  for (int i = threadIdx.x; i < ATT_QT * dh; i += blockDim.x) {
    const int r = i / dh, d = i % dh, t = q0 + r;
    qs[i] = t < Tn ? to_f<T>(base[t * rs + h * dh + d]) : 0.f;
  }
  float* row = lg + warp * span;
  for (int kc = 0; kc < span; kc += ATT_KC) {
    __syncthreads();
    for (int i = threadIdx.x; i < ATT_KC * dh; i += blockDim.x) {
      const int j = i / dh, d = i % dh, pos = ks0 + kc + j;
      kv[j * (dh + 1) + d] =
          (kc + j < span && pos >= 0 && pos < Tn) ? to_f<T>(base[pos * rs + D + h * dh + d]) : 0.f;
    }
    __syncthreads();
    for (int j = lane; j < ATT_KC && kc + j < span; j += 32) {
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qs[warp * dh + d], kv[j * (dh + 1) + d], s);
      const int pos = ks0 + kc + j;
      const bool valid = pos >= 0 && pos < Tn && mask[(size_t)b * Tn + pos] != 0.f;
      row[kc + j] = s / sqrt_dh + (valid ? 0.f : NEG);
    }
  }
  __syncwarp();
  float mx = -INFINITY;
  for (int j = lane; j < span; j += 32) mx = fmaxf(mx, row[j]);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < span; j += 32) {
    const float e = expf(row[j] - mx);
    row[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int j = lane; j < span; j += 32) row[j] = rnd<T>(row[j] / sum);
  __syncwarp();

  float o[4] = {0.f, 0.f, 0.f, 0.f};  // dims lane, lane+32, lane+64, lane+96
  for (int kc = 0; kc < span; kc += ATT_KC) {
    __syncthreads();
    for (int i = threadIdx.x; i < ATT_KC * dh; i += blockDim.x) {
      const int j = i / dh, d = i % dh, pos = ks0 + kc + j;
      kv[j * (dh + 1) + d] = (kc + j < span && pos >= 0 && pos < Tn)
                                 ? to_f<T>(base[pos * rs + 2 * D + h * dh + d])
                                 : 0.f;
    }
    __syncthreads();
    const int jn = min(ATT_KC, span - kc);
    for (int j = 0; j < jn; ++j) {
      const float p = row[kc + j];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int d = lane + 32 * u;
        if (d < dh) o[u] = fmaf(p, kv[j * (dh + 1) + d], o[u]);
      }
    }
  }
  const int t = q0 + warp;
  if (t < Tn) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int d = lane + 32 * u;
      if (d < dh) out[((size_t)b * Tn + t) * D + h * dh + d] = from_f<T>(o[u]);
    }
  }
}

template <typename T>
int attention(const T* qkv, T* out, const float* mask, int B, int Tn, int D, int H, int window,
              cudaStream_t s) {
  const int dh = D / H;
  const int span = window > 0 ? 3 * window : Tn;
  const size_t bytes = sizeof(float) * (ATT_QT * dh + ATT_KC * (dh + 1) + (size_t)ATT_QT * span);
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    PORT_RETURN_IF_ERROR();
  }
  dim3 grid((Tn + ATT_QT - 1) / ATT_QT, H, B);
  attention_kernel<T><<<grid, 32 * ATT_QT, bytes, s>>>(qkv, out, mask, Tn, D, H, window,
                                                        sqrtf((float)dh));
  PORT_RETURN_IF_ERROR();
  return 0;
}

// ------------------------------------------------------------------ bf16: tensor cores

constexpr int ATC_TILE = 64;  // queries per block (4 warps x 16) and keys per staged tile

// D[16 x 8] += A[16 x 16] * B[16 x 8], bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared without passing through registers; zeros when !valid.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(tc::smem_u32(dst)), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Waits until at most N of this thread's committed groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows pos0 .. pos0+63 of one head's q, k or v (columns col .. col+DH of the
// batch's qkv rows) into a [64][DH + 8] tile; rows outside [0, Tn) become zeros.
// The 8-element pad keeps fragment loads off each other's banks.
template <int DH>
__device__ __forceinline__ void load_head_tile(__nv_bfloat16* dst, const __nv_bfloat16* base, size_t rs, int col,
                                               int pos0, int Tn) {
  constexpr int CPR = DH / 8;  // 16-byte pieces per row
  for (int i = threadIdx.x; i < ATC_TILE * CPR; i += blockDim.x) {
    const int r = i / CPR, c = i % CPR, pos = pos0 + r;
    const bool ok = pos >= 0 && pos < Tn;
    cp_async_16(dst + r * (DH + 8) + c * 8, base + (ok ? (size_t)pos * rs + col + c * 8 : 0), ok);
  }
}

// Logits of this warp's 16 queries against the 64 staged keys, as mma C fragments:
// s[nt][0, 1] are (row g, keys 8nt + 2tg, + 1), s[nt][2, 3] the same keys for row
// g + 8. logit = q.k * inv_sqrt_dh + kbias[key] for a key inside the row's window
// [lo, hi), -inf (no part of the softmax) outside it. A warp has few neighbours on
// its SM here (B*H*T/16 warps in all), so the count of instructions per logit is
// what the kernel's time is made of: the window test is skipped for a tile that
// lies inside both rows' windows.
template <int DH>
__device__ __forceinline__ void tile_logits(float (&s)[8][4], const uint32_t (&qa)[DH / 16][4],
                                            const __nv_bfloat16* ks, const float* kbias, int pos0, int lo_a,
                                            int hi_a, int lo_b, int hi_b, float inv_sqrt_dh) {
  constexpr int LD = DH + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  const bool inside = pos0 >= max(lo_a, lo_b) && pos0 + ATC_TILE <= min(hi_a, hi_b);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const __nv_bfloat16* kr = ks + (nt * 8 + g) * LD + kk * 16 + 2 * tg;
      mma_16816(c, qa[kk], *reinterpret_cast<const uint32_t*>(kr), *reinterpret_cast<const uint32_t*>(kr + 8));
    }
    const float2 kb = *reinterpret_cast<const float2*>(kbias + nt * 8 + 2 * tg);
    s[nt][0] = fmaf(c[0], inv_sqrt_dh, kb.x);
    s[nt][1] = fmaf(c[1], inv_sqrt_dh, kb.y);
    s[nt][2] = fmaf(c[2], inv_sqrt_dh, kb.x);
    s[nt][3] = fmaf(c[3], inv_sqrt_dh, kb.y);
    if (!inside) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = pos0 + nt * 8 + 2 * tg + (e & 1);
        const int lo = e < 2 ? lo_a : lo_b, hi = e < 2 ? hi_a : hi_b;
        if (pos < lo || pos >= hi) s[nt][e] = -INFINITY;
      }
    }
  }
}

// Attention for one (batch, head, tile of 64 queries), bf16, on the tensor cores;
// the function of attention_kernel above: window == 0 takes every key of the
// sequence, else the keys of the query's block and both neighbours, those outside
// the sequence with logit NEG (zero k, zero v), as the zero-edged blocks of
// layers.local_mha; a masked key adds NEG; every key's own mask value is read.
template <int DH>
__global__ void __launch_bounds__(128)
attention_tc_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                    const float* __restrict__ mask, int Tn, int D, int window, float inv_sqrt_dh) {
  constexpr int LD = DH + 8;
  // K, V and the key bias are double-buffered: tile c + 1 is on its way while tile c
  // is multiplied.
  __shared__ __align__(16) __nv_bfloat16 qs[ATC_TILE * LD];
  __shared__ __align__(16) __nv_bfloat16 ks[2][ATC_TILE * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[2][ATC_TILE * LD];
  __shared__ __align__(8) float kbias[2][ATC_TILE];

  const int q0 = blockIdx.x * ATC_TILE, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  const size_t rs = 3 * (size_t)D;
  const __nv_bfloat16* base = qkv + (size_t)b * Tn * rs;
  const float* mrow = mask + (size_t)b * Tn;

  // Keys this tile walks, and each of this thread's two rows' own window.
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  int k_begin = 0, k_end = Tn, lo_a = 0, hi_a = Tn, lo_b = 0, hi_b = Tn;
  if (window > 0) {
    k_begin = (q0 / window) * window - window;
    k_end = (min(q0 + ATC_TILE - 1, Tn - 1) / window) * window + 2 * window;
    lo_a = (row_a / window) * window - window;
    hi_a = lo_a + 3 * window;
    lo_b = (row_b / window) * window - window;
    hi_b = lo_b + 3 * window;
  }

  // Stages the keys pos0 .. pos0+63 (and their values) into buffer `buf`: one
  // cp.async group. kbias is 0 for a key to attend to, NEG for a masked key or one
  // outside the sequence.
  auto stage = [&](int buf, int pos0, bool with_v) {
    load_head_tile<DH>(ks[buf], base, rs, D + h * DH, pos0, Tn);
    if (with_v) load_head_tile<DH>(vs[buf], base, rs, 2 * D + h * DH, pos0, Tn);
    if (threadIdx.x < ATC_TILE) {
      const int pos = pos0 + threadIdx.x;
      kbias[buf][threadIdx.x] = (pos >= 0 && pos < Tn && mrow[pos] != 0.f) ? 0.f : NEG;
    }
    cp_async_commit();
  };

  load_head_tile<DH>(qs, base, rs, h * DH, q0, Tn);
  cp_async_commit();
  stage(0, k_begin, false);
  cp_async_wait<1>();  // Q has landed; the first K tile may still be in flight
  __syncthreads();
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const __nv_bfloat16* qr = qs + (warp * 16 + g) * LD + kk * 16 + 2 * tg;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(qr);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(qr + 8 * LD);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(qr + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(qr + 8 * LD + 8);
  }

  float s[8][4];
  // Pass 1: each row's max and sum of exp(l - max). A thread keeps the part of the
  // sum over its own columns; the four threads of a row share every max, so the
  // parts are rescaled alike and added once at the end.
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  int buf = 0;
  for (int pos0 = k_begin; pos0 < k_end; pos0 += ATC_TILE, buf ^= 1) {
    // The next tile, or, after the last, the first tile of pass 2 (with its values).
    const bool last = pos0 + ATC_TILE >= k_end;
    stage(buf ^ 1, last ? k_begin : pos0 + ATC_TILE, last);
    cp_async_wait<1>();
    __syncthreads();
    tile_logits<DH>(s, qa, ks[buf], kbias[buf], pos0, lo_a, hi_a, lo_b, hi_b, inv_sqrt_dh);
    float cm_a = -INFINITY, cm_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      cm_a = fmaxf(cm_a, fmaxf(s[nt][0], s[nt][1]));
      cm_b = fmaxf(cm_b, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      cm_a = fmaxf(cm_a, __shfl_xor_sync(0xffffffffu, cm_a, o));
      cm_b = fmaxf(cm_b, __shfl_xor_sync(0xffffffffu, cm_b, o));
    }
    const float n_a = fmaxf(m_a, cm_a), n_b = fmaxf(m_b, cm_b);
    if (n_a > -INFINITY) {
      float add = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) add += __expf(s[nt][0] - n_a) + __expf(s[nt][1] - n_a);
      l_a = l_a * __expf(m_a - n_a) + add;
      m_a = n_a;
    }
    if (n_b > -INFINITY) {
      float add = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) add += __expf(s[nt][2] - n_b) + __expf(s[nt][3] - n_b);
      l_b = l_b * __expf(m_b - n_b) + add;
      m_b = n_b;
    }
    __syncthreads();  // this buffer is the target of the next iteration's loads
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
  }
  // Rows past the sequence's end in the last tile may have seen no key: they are
  // not stored, and must only stay finite.
  if (!(m_a > -INFINITY)) { m_a = 0.f; l_a = 1.f; }
  if (!(m_b > -INFINITY)) { m_b = 0.f; l_b = 1.f; }

  // Pass 2: the same logits again, p = exp(l - max) / sum rounded to bf16, o += p.v.
  const float r_a = 1.0f / l_a, r_b = 1.0f / l_b;
  float o[DH / 8][4];
#pragma unroll
  for (int dn = 0; dn < DH / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  for (int pos0 = k_begin; pos0 < k_end; pos0 += ATC_TILE, buf ^= 1) {
    if (pos0 + ATC_TILE < k_end) {
      stage(buf ^ 1, pos0 + ATC_TILE, true);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    tile_logits<DH>(s, qa, ks[buf], kbias[buf], pos0, lo_a, hi_a, lo_b, hi_b, inv_sqrt_dh);
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {  // 16 keys: two logit fragments make one A fragment
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float (&f)[4] = s[2 * kt + half];
        const __nv_bfloat162 ra = __floats2bfloat162_rn(__expf(f[0] - m_a) * r_a, __expf(f[1] - m_a) * r_a);
        const __nv_bfloat162 rb = __floats2bfloat162_rn(__expf(f[2] - m_b) * r_b, __expf(f[3] - m_b) * r_b);
        pa[2 * half] = *reinterpret_cast<const uint32_t*>(&ra);
        pa[2 * half + 1] = *reinterpret_cast<const uint32_t*>(&rb);
      }
#pragma unroll
      for (int dn = 0; dn < DH / 8; ++dn) {
        // B fragment of v[16 keys][8 dims]: two 8 x 8 blocks, transposed on load.
        uint32_t b0, b1;
        const uint32_t addr = tc::smem_u32(vs[buf] + (kt * 16 + (lane & 15)) * LD + dn * 8);
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                     : "=r"(b0), "=r"(b1)
                     : "r"(addr));
        mma_16816(o[dn], pa, b0, b1);
      }
    }
    __syncthreads();  // this buffer is the target of the next iteration's loads
  }
#pragma unroll
  for (int dn = 0; dn < DH / 8; ++dn) {
    const int d = h * DH + dn * 8 + 2 * tg;
    if (row_a < Tn)
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * Tn + row_a) * D + d) =
          __floats2bfloat162_rn(o[dn][0], o[dn][1]);
    if (row_b < Tn)
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * Tn + row_b) * D + d) =
          __floats2bfloat162_rn(o[dn][2], o[dn][3]);
  }
}

inline int attention_tc(const __nv_bfloat16* qkv, __nv_bfloat16* out, const float* mask, int B, int Tn, int D,
                        int H, int window, cudaStream_t s) {
  const int dh = D / H;
  dim3 grid((Tn + ATC_TILE - 1) / ATC_TILE, H, B);
  const float sq = 1.0f / sqrtf((float)dh);
  if (dh == 64) attention_tc_kernel<64><<<grid, 128, 0, s>>>(qkv, out, mask, Tn, D, window, sq);
  else if (dh == 32) attention_tc_kernel<32><<<grid, 128, 0, s>>>(qkv, out, mask, Tn, D, window, sq);
  else if (dh == 16) attention_tc_kernel<16><<<grid, 128, 0, s>>>(qkv, out, mask, Tn, D, window, sq);
  else return (int)cudaErrorInvalidValue;
  PORT_RETURN_IF_ERROR();
  return 0;
}

// The bf16 stack. Weights are the transposed copies of pack_params (wqkv_t [L, 3D, D],
// wo_t [L, D, D], w1_t [L, F, 3D], w2_t [L, D, 3F]); plans holds (warpgroups, tile
// columns, split) for the QKV, out-projection, conv-FFN1 and conv-FFN2 products; ws
// is the f32 workspace of the split products.
inline int stack_forward_tc(int B, int Tn, int D, int H, int F, int L, int window, const float* mask,
                            __nv_bfloat16* act, const float* ln1_g, const float* ln1_b, const float* ln2_g,
                            const float* ln2_b, const __nv_bfloat16* wqkv_t, const float* bqkv,
                            const __nv_bfloat16* wo_t, const float* bo, const __nv_bfloat16* w1_t,
                            const float* b1, const __nv_bfloat16* w2_t, const float* b2, const float* lno_g,
                            const float* lno_b, __nv_bfloat16* normed, __nv_bfloat16* qkv, __nv_bfloat16* att,
                            __nv_bfloat16* hres, __nv_bfloat16* h1, __nv_bfloat16* out, const int* plans,
                            float* ws, cudaStream_t s) {
  using T = __nv_bfloat16;
  const int M = B * Tn;
  const float eps = 1e-5f;
  const tc::Plan p_qkv{plans[0], plans[1], plans[2]}, p_o{plans[3], plans[4], plans[5]},
      p_1{plans[6], plans[7], plans[8]}, p_2{plans[9], plans[10], plans[11]};
  int rc;
  for (int l = 0; l < L; ++l) {
    ln_rows<T>(act, normed, ln1_g + (size_t)l * D, ln1_b + (size_t)l * D, M, D, eps, s);
    PORT_RETURN_IF_ERROR();
    rc = tc::gemm_tc(normed, wqkv_t + (size_t)l * D * 3 * D, qkv, 1, M, D, 1, 3 * D, EPI_BIAS,
                     bqkv + (size_t)l * 3 * D, nullptr, nullptr, nullptr, ws, p_qkv, s);
    if (rc) return rc;
    rc = attention_tc(qkv, att, mask, B, Tn, D, H, window, s);
    if (rc) return rc;
    rc = tc::gemm_tc(att, wo_t + (size_t)l * D * D, hres, 1, M, D, 1, D, EPI_RESID_MASK, bo + (size_t)l * D,
                     act, mask, nullptr, ws, p_o, s);
    if (rc) return rc;
    ln_rows<T>(hres, normed, ln2_g + (size_t)l * D, ln2_b + (size_t)l * D, M, D, eps, s);
    PORT_RETURN_IF_ERROR();
    rc = tc::gemm_tc(normed, w1_t + (size_t)l * 3 * D * F, h1, B, Tn, D, 3, F, EPI_BIAS_RELU,
                     b1 + (size_t)l * F, nullptr, nullptr, nullptr, ws, p_1, s);
    if (rc) return rc;
    rc = tc::gemm_tc(h1, w2_t + (size_t)l * 3 * F * D, act, B, Tn, F, 3, D, EPI_RESID_MASK,
                     b2 + (size_t)l * D, hres, mask, nullptr, ws, p_2, s);
    if (rc) return rc;
  }
  ln_rows<T>(act, out, lno_g, lno_b, M, D, eps, s);
  PORT_RETURN_IF_ERROR();
  return 0;
}

// ------------------------------------------------------------------ float32: CUDA cores

template <typename T>
int stack_forward(int B, int Tn, int D, int H, int F, int L, int window, const float* mask,
                  T* act, const float* ln1_g, const float* ln1_b, const float* ln2_g,
                  const float* ln2_b, const T* wqkv, const float* bqkv, const T* wo,
                  const float* bo, const T* w1, const float* b1, const T* w2, const float* b2,
                  const float* lno_g, const float* lno_b, T* normed, T* qkv, T* att, T* hres,
                  T* h1, T* out, cudaStream_t s) {
  const int M = B * Tn;
  const float eps = 1e-5f;
  for (int l = 0; l < L; ++l) {
    ln_rows<T>(act, normed, ln1_g + (size_t)l * D, ln1_b + (size_t)l * D, M, D, eps, s);
    PORT_RETURN_IF_ERROR();
    gemm<T, A_ROWS, EPI_BIAS>(normed, wqkv + (size_t)l * D * 3 * D, qkv, M, 3 * D, D, Tn, D,
                              bqkv + (size_t)l * 3 * D, nullptr, nullptr, nullptr, s);
    PORT_RETURN_IF_ERROR();
    const int rc = attention<T>(qkv, att, mask, B, Tn, D, H, window, s);
    if (rc) return rc;
    gemm<T, A_ROWS, EPI_RESID_MASK>(att, wo + (size_t)l * D * D, hres, M, D, D, Tn, D,
                                    bo + (size_t)l * D, act, mask, nullptr, s);
    PORT_RETURN_IF_ERROR();
    ln_rows<T>(hres, normed, ln2_g + (size_t)l * D, ln2_b + (size_t)l * D, M, D, eps, s);
    PORT_RETURN_IF_ERROR();
    gemm<T, A_CONV3, EPI_BIAS_RELU>(normed, w1 + (size_t)l * 3 * D * F, h1, M, F, 3 * D, Tn, D,
                                    b1 + (size_t)l * F, nullptr, nullptr, nullptr, s);
    PORT_RETURN_IF_ERROR();
    gemm<T, A_CONV3, EPI_RESID_MASK>(h1, w2 + (size_t)l * 3 * F * D, act, M, D, 3 * F, Tn, F,
                                     b2 + (size_t)l * D, hres, mask, nullptr, s);
    PORT_RETURN_IF_ERROR();
  }
  ln_rows<T>(act, out, lno_g, lno_b, M, D, eps, s);
  PORT_RETURN_IF_ERROR();
  return 0;
}

}  // namespace port

// dtype 0 = float32, 1 = bfloat16 (weights and activations; biases, LN
// parameters and the mask are float32). `act` holds the input [B, T, D] and is
// overwritten; the result goes to `out`. float32 reads the weights as packed
// ([K, N]) and ignores `plans` and `ws`; bfloat16 reads their transposed copies and
// the per-product plans (12 ints, host memory). Returns a cudaError_t code.
extern "C" int transformer_stack_forward(
    int dtype, int B, int Tn, int D, int H, int F, int L, int window, const void* mask,
    void* act, const void* ln1_g, const void* ln1_b, const void* ln2_g, const void* ln2_b,
    const void* wqkv, const void* bqkv, const void* wo, const void* bo, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* lno_g, const void* lno_b,
    void* normed, void* qkv, void* att, void* hres, void* h1, void* out, const void* plans,
    void* ws, void* stream) {
  auto s = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
#define PORT_ARGS(T)                                                                         \
  B, Tn, D, H, F, L, window, f(mask), (T*)act, f(ln1_g), f(ln1_b), f(ln2_g), f(ln2_b),       \
      (const T*)wqkv, f(bqkv), (const T*)wo, f(bo), (const T*)w1, f(b1), (const T*)w2, f(b2), \
      f(lno_g), f(lno_b), (T*)normed, (T*)qkv, (T*)att, (T*)hres, (T*)h1, (T*)out
  if (dtype == 0) return port::stack_forward<float>(PORT_ARGS(float), s);
  if (dtype == 1)
    return port::stack_forward_tc(PORT_ARGS(__nv_bfloat16), (const int*)plans, (float*)ws, s);
#undef PORT_ARGS
  return (int)cudaErrorInvalidValue;
}
