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
// What bounds it on the H100: the GEMMs are ~95% of the operations (at the
// decoder's B=4, T=512: ~11 GFLOP a stack), so the stack is compute-bound. This
// first version runs them on the CUDA cores from shared-memory tiles (f32 FMA even
// for bf16 storage) and re-reads K/V per query tile from L2; wgmma tiles fed by
// TMA and one persistent launch for the whole stack are the path to the bound.
//
// bf16 mode rounds where the Pallas kernel rounds: qkv, the probabilities p, the
// attention output, h_res, the ReLU output and the stored activation. Logits,
// softmax, LN statistics and all accumulation stay f32.
#include "common.cuh"

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
// overwritten; the result goes to `out`. Returns a cudaError_t code.
extern "C" int transformer_stack_forward(
    int dtype, int B, int Tn, int D, int H, int F, int L, int window, const void* mask,
    void* act, const void* ln1_g, const void* ln1_b, const void* ln2_g, const void* ln2_b,
    const void* wqkv, const void* bqkv, const void* wo, const void* bo, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* lno_g, const void* lno_b,
    void* normed, void* qkv, void* att, void* hres, void* h1, void* out, void* stream) {
  auto s = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
#define PORT_ARGS(T)                                                                         \
  B, Tn, D, H, F, L, window, f(mask), (T*)act, f(ln1_g), f(ln1_b), f(ln2_g), f(ln2_b),       \
      (const T*)wqkv, f(bqkv), (const T*)wo, f(bo), (const T*)w1, f(b1), (const T*)w2, f(b2), \
      f(lno_g), f(lno_b), (T*)normed, (T*)qkv, (T*)att, (T*)hres, (T*)h1, (T*)out, s
  if (dtype == 0) return port::stack_forward<float>(PORT_ARGS(float));
  if (dtype == 1) return port::stack_forward<__nv_bfloat16>(PORT_ARGS(__nv_bfloat16));
#undef PORT_ARGS
  return (int)cudaErrorInvalidValue;
}
