// K1-gathered: K1's length-adaptive redesign (split-KV).
//
// Replaces the TPU kernel of backpacks_flash_attn_tpu/ops/decode_attention.py
//   decode_attention_gathered  (:238, Pallas body _gathered_kernel :184)
// It computes K1's function (decode_attention.cu):
//   out[e] = softmax_{s < len[e]}((q[e] . kt[e,:,s]) * ks[e,s]) * vs[e,s] @ v[e,s,:]
// q pre-scaled (E, dk); kt (E, dk, S); v (E, S, dv); optional f32 ks/vs (E,
// S); a scalar or per-row length; out (E, dv) in q's dtype. bf16 q over int8
// or bf16 caches, f32 q over int8 or f32; any outer strides (window slices),
// unit inner stride. All arithmetic is f32. (K1's two other redesigns,
// selector and blockdiag, run K1's own body: decode_attention_selector.cu and
// decode_attention.cu.)
//
// Bound on the H100: memory, as K1 (~2 flops a byte read).
//
// The TPU kernel walks S in block_s blocks with an online softmax
// and never reads the blocks past the valid length. Here that walk is split
// across CTAs (flash-decoding): the grid is (E, chunks), each chunk a whole
// number of blocks; a CTA whose chunk starts at or past its row's length
// exits before any load; the others write an f32 partial (acc unnormalized,
// m, l) to a workspace, and a second launch merges a row's partials as
// merge_softmax_segments (decode_attention.py:1270) does, divides by l and
// writes 0 for a row of length 0 (the TPU kernel's result); when a row is one
// chunk (many rows: the card is full without splitting), that CTA normalizes
// and writes the output itself and the merge is not launched. Scores are held a
// chunk at a time, so S has no cap, and a few rows of long caches (gpt-generate:
// E = 96, S = 2112) still spread over every SM, where K1 runs one CTA a row.
#include "common.cuh"

namespace {

constexpr int kChunkThreads = 256;
constexpr int kMergeThreads = 128;
constexpr float kNeg = -1e30f;   // decode_attention.py NEG

__device__ __forceinline__ int row_len(const int* lengths, int scalar_len, int e) {
  return lengths != nullptr ? lengths[e] : scalar_len;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kChunkThreads)
gathered_partial_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kt,
                        const float* __restrict__ ks, const TKV* __restrict__ v,
                        const float* __restrict__ vs, const int* __restrict__ lengths,
                        TQ* __restrict__ out, float* __restrict__ ws_acc,
                        float* __restrict__ ws_ml, int dk, int S,
                        int dv, int scalar_len, int chunk, int n_chunks, long long q_se,
                        long long kt_se, long long kt_sd, long long v_se, long long v_ss,
                        long long ks_se, long long vs_se) {
  extern __shared__ float smem[];
  float* qs = smem;          // [dk]
  float* p = qs + dk;        // [chunk] scores, then probabilities times vs
  float* red = p + chunk;    // [32]
  float* part = red + 32;    // [groups * dv]

  const int e = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  const int n = min(row_len(lengths, scalar_len, e), S);
  const int c0 = c * chunk;
  if (c0 >= n) {             // past the valid prefix: no load, no partial
    if (n_chunks == 1)       // ... and no merge: an empty row's 0
      for (int d = tid; d < dv; d += kChunkThreads)
        out[static_cast<long long>(e) * dv + d] = from_f32<TQ>(0.f);
    return;
  }
  const int cn = min(chunk, n - c0);

  for (int d = tid; d < dk; d += kChunkThreads) qs[d] = to_f32(q[e * q_se + d]);
  __syncthreads();

  const TKV* ktr = kt + e * kt_se + c0;
  float local_max = -INFINITY;
  for (int j = tid; j < cn; j += kChunkThreads) {
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < dk; ++d) acc += qs[d] * to_f32(ktr[d * kt_sd + j]);
    if (ks != nullptr) acc *= ks[e * ks_se + c0 + j];
    p[j] = acc;
    local_max = fmaxf(local_max, acc);
  }
  const float m = block_max(local_max, red);
  float local_sum = 0.f;
  for (int j = tid; j < cn; j += kChunkThreads) {
    const float x = expf(p[j] - m);
    local_sum += x;
    p[j] = x * (vs != nullptr ? vs[e * vs_se + c0 + j] : 1.f);
  }
  const float l = block_sum(local_sum, red);
  __syncthreads();

  // acc = p @ v over the chunk: threads along dv (4 a thread), s across groups
  const int tpg = dv >> 2;
  const int groups = kChunkThreads / tpg;
  const int g = tid / tpg;
  const int col = (tid - g * tpg) * 4;
  if (g < groups) {
    const TKV* vr = v + e * v_se + c0 * v_ss + col;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
    for (int s = g; s < cn; s += groups) {
      const float ps = p[s];
      const Vec4 x = load4(vr + s * v_ss);
      a0 += ps * x.x;
      a1 += ps * x.y;
      a2 += ps * x.z;
      a3 += ps * x.w;
    }
    float* pr = part + g * dv + col;
    pr[0] = a0;
    pr[1] = a1;
    pr[2] = a2;
    pr[3] = a3;
  }
  __syncthreads();
  const long long slot = static_cast<long long>(e) * n_chunks + c;
  if (n_chunks == 1) {       // the whole row in one chunk: normalize here
    const float inv = 1.f / l;
    for (int d = tid; d < dv; d += kChunkThreads) {
      float acc = 0.f;
      for (int gg = 0; gg < groups; ++gg) acc += part[gg * dv + d];
      out[slot * dv + d] = from_f32<TQ>(acc * inv);
    }
    return;
  }
  float* wa = ws_acc + slot * dv;
  for (int d = tid; d < dv; d += kChunkThreads) {
    float acc = 0.f;
    for (int gg = 0; gg < groups; ++gg) acc += part[gg * dv + d];
    wa[d] = acc;
  }
  if (tid == 0) {
    ws_ml[2 * slot] = m;
    ws_ml[2 * slot + 1] = l;
  }
}

// The merge of a row's partials: m = max m_c, w_c = exp(m_c - m), out =
// sum w_c acc_c / sum w_c l_c; 0 when the row has no valid position.
template <typename TQ>
__global__ void __launch_bounds__(kMergeThreads)
gathered_merge_kernel(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
                      const int* __restrict__ lengths, TQ* __restrict__ out, int S, int dv,
                      int scalar_len, int chunk, int n_chunks) {
  const int e = blockIdx.x;
  const int n = min(row_len(lengths, scalar_len, e), S);
  const int nc = n > 0 ? (n + chunk - 1) / chunk : 0;
  const long long base = static_cast<long long>(e) * n_chunks;
  const float* ml = ws_ml + 2 * base;
  float m = kNeg;
  for (int c = 0; c < nc; ++c) m = fmaxf(m, ml[2 * c]);
  float l = 0.f;
  for (int c = 0; c < nc; ++c) l += ml[2 * c + 1] * expf(ml[2 * c] - m);
  const float inv = l > 0.f ? 1.f / l : 0.f;
  for (int d = threadIdx.x; d < dv; d += kMergeThreads) {
    float acc = 0.f;
    for (int c = 0; c < nc; ++c) acc += ws_acc[(base + c) * dv + d] * expf(ml[2 * c] - m);
    out[static_cast<long long>(e) * dv + d] = from_f32<TQ>(acc * inv);
  }
}

template <typename TQ, typename TKV>
int gathered(const void* q, const void* kt, const void* ks, const void* v, const void* vs,
             const void* lengths, void* out, void* ws_acc, void* ws_ml, long long E,
             long long dk, long long S, long long dv, long long scalar_len, long long chunk,
             long long n_chunks, long long q_se, long long kt_se, long long kt_sd,
             long long v_se, long long v_ss, long long ks_se, long long vs_se,
             cudaStream_t stream) {
  const long long groups = kChunkThreads / (dv / 4);
  const size_t smem = static_cast<size_t>(dk + chunk + 32 + groups * dv) * sizeof(float);
  auto kern = gathered_partial_kernel<TQ, TKV>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  const dim3 grid(static_cast<unsigned>(E), static_cast<unsigned>(n_chunks));
  kern<<<grid, kChunkThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kt), static_cast<const float*>(ks),
      static_cast<const TKV*>(v), static_cast<const float*>(vs),
      static_cast<const int*>(lengths), static_cast<TQ*>(out), static_cast<float*>(ws_acc),
      static_cast<float*>(ws_ml), static_cast<int>(dk), static_cast<int>(S),
      static_cast<int>(dv), static_cast<int>(scalar_len), static_cast<int>(chunk),
      static_cast<int>(n_chunks), q_se, kt_se, kt_sd, v_se, v_ss, ks_se, vs_se);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return static_cast<int>(err);
  gathered_merge_kernel<TQ><<<static_cast<unsigned>(E), kMergeThreads, 0, stream>>>(
      static_cast<const float*>(ws_acc), static_cast<const float*>(ws_ml),
      static_cast<const int*>(lengths), static_cast<TQ*>(out), static_cast<int>(S),
      static_cast<int>(dv), static_cast<int>(scalar_len), static_cast<int>(chunk),
      static_cast<int>(n_chunks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int decode_attention_gathered_launch(
    const void* q, const void* kt, const void* ks, const void* v, const void* vs,
    const void* lengths, void* out, void* ws_acc, void* ws_ml, long long E, long long dk,
    long long S, long long dv, long long scalar_len, long long chunk, long long n_chunks,
    long long q_se, long long kt_se, long long kt_sd, long long v_se, long long v_ss,
    long long ks_se, long long vs_se, long long q_dtype, long long kv_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define G_ARGS q, kt, ks, v, vs, lengths, out, ws_acc, ws_ml, E, dk, S, dv, scalar_len, chunk, \
               n_chunks, q_se, kt_se, kt_sd, v_se, v_ss, ks_se, vs_se, st
  if (q_dtype == DT_BF16 && kv_dtype == DT_I8) return gathered<__nv_bfloat16, int8_t>(G_ARGS);
  if (q_dtype == DT_BF16 && kv_dtype == DT_BF16)
    return gathered<__nv_bfloat16, __nv_bfloat16>(G_ARGS);
  if (q_dtype == DT_F32 && kv_dtype == DT_I8) return gathered<float, int8_t>(G_ARGS);
  if (q_dtype == DT_F32 && kv_dtype == DT_F32) return gathered<float, float>(G_ARGS);
#undef G_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
