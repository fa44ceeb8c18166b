// K1's three redesigns: gathered (split-KV), selector and blockdiag
// (row-grouped, a warp per row).
//
// Replace the TPU kernels of backpacks_flash_attn_tpu/ops/decode_attention.py
//   decode_attention_gathered  (:238, Pallas body _gathered_kernel :184)
//   decode_attention_selector  (:365, _selector_kernel :311)
//   decode_attention_blockdiag (:465, _blockdiag_kernel :415)
// Each computes K1's function (decode_attention.cu):
//   out[e] = softmax_{s < len[e]}((q[e] . kt[e,:,s]) * ks[e,s]) * vs[e,s] @ v[e,s,:]
// q pre-scaled (E, dk); kt (E, dk, S); v (E, S, dv), or (E, dv, S) for the
// selector; optional f32 ks/vs (E, S); a scalar or per-row length; out (E, dv)
// in q's dtype. bf16 q over int8 or bf16 caches, f32 q over int8 or f32; any
// outer strides (window slices), unit inner stride. All arithmetic is f32.
//
// Bound on the H100: memory, as K1 (~2 flops a byte read).
//
// gathered: the TPU kernel walks S in block_s blocks with an online softmax
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
//
// selector / blockdiag: the TPU forms turn the per-row matvecs into 0/1
// selector or block-diagonal matmuls for the MXU; at ~2 flops a byte the H100
// needs no such trick. Rows are grouped per CTA by the TPU kernel's
// rows_per_program rule (the schedule only, never the result), each row taken
// by one warp (at most 32 warps a CTA, fewer when the warps' score rows
// would overflow shared memory, each then looping over rows). Lanes
// run along s for the scores (coalesced in (E, dk, S)); the normalized
// probabilities times vs sit in shared memory; then the selector's lanes run
// along s again over the transposed values (E, dv, S), with a warp reduction
// per output column, and blockdiag's along dv over (E, S, dv), 4 columns a
// lane. A row of length 0 attends uniformly over all S columns, as the masked
// softmax of both TPU kernels does.
#include "common.cuh"

namespace {

constexpr int kChunkThreads = 256;
constexpr int kMergeThreads = 128;
constexpr int kMaxWarps = 32;
constexpr float kNeg = -1e30f;   // decode_attention.py NEG

__device__ __forceinline__ int row_len(const int* lengths, int scalar_len, int e) {
  return lengths != nullptr ? lengths[e] : scalar_len;
}

// ------------------------------------------------------------ gathered

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

// ------------------------------------------------------------ selector / blockdiag

// One warp's row: q in qs, scores then probabilities times vs in p, then out.
// VT: values (E, dv, S) (selector); else (E, S, dv) (blockdiag). v_s1 is the
// stride of v's middle axis.
template <typename TQ, typename TKV, bool VT>
__global__ void __launch_bounds__(kMaxWarps * 32)
rows_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kt, const float* __restrict__ ks,
            const TKV* __restrict__ v, const float* __restrict__ vs,
            const int* __restrict__ lengths, TQ* __restrict__ out, int E, int dk, int S, int dv,
            int scalar_len, int rows, long long q_se, long long kt_se, long long kt_sd,
            long long v_se, long long v_s1, long long ks_se, long long vs_se) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  float* qs = smem + static_cast<long long>(warp) * (dk + S);   // [dk]
  float* p = qs + dk;                                          // [S]

  for (int r = warp; r < rows; r += nwarps) {
    const int e = blockIdx.x * rows + r;
    if (e >= E) break;
    const int len = row_len(lengths, scalar_len, e);
    // an empty row attends uniformly over all S columns (every score NEG)
    const bool empty = len <= 0;
    const int n = empty ? S : min(len, S);
    for (int d = lane; d < dk; d += 32) qs[d] = to_f32(q[e * q_se + d]);
    __syncwarp();

    // scores: lanes along s, four positions a lane per pass
    const TKV* ktr = kt + e * kt_se;
    float mx = -INFINITY;
    for (int base = 0; base < n; base += 128) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      if (!empty) {
        for (int d = 0; d < dk; ++d) {
          const float qd = qs[d];
          const TKV* kd = ktr + d * kt_sd + base + lane;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (base + lane + 32 * j < n) a[j] += qd * to_f32(kd[32 * j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = base + lane + 32 * j;
        if (s < n) {
          float x = a[j];
          if (ks != nullptr && !empty) x *= ks[e * ks_se + s];
          p[s] = x;
          mx = fmaxf(mx, x);
        }
      }
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = lane; s < n; s += 32) {   // the same lane wrote p[s] above
      const float x = expf(p[s] - mx);
      p[s] = x;
      sum += x;
    }
    const float inv = 1.f / warp_sum(sum);
    for (int s = lane; s < n; s += 32)
      p[s] = p[s] * inv * (vs != nullptr ? vs[e * vs_se + s] : 1.f);
    __syncwarp();

    TQ* o = out + static_cast<long long>(e) * dv;
    const TKV* vr = v + e * v_se;
    if (VT) {
      // lanes along s over the transposed values, four columns at a time
      for (int d0 = 0; d0 < dv; d0 += 4) {
        float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int s = lane; s < n; s += 32) {
          const float ps = p[s];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (d0 + j < dv) a[j] += ps * to_f32(vr[(d0 + j) * v_s1 + s]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = warp_sum(a[j]);
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (d0 + j < dv) o[d0 + j] = from_f32<TQ>(a[j]);
        }
      }
    } else {
      // lanes along dv, 4 columns a lane, one pass per 128 columns (few
      // registers, so the unrolled position loop keeps loads in flight);
      // when dv / 4 divides 32, the warp splits into groups over s and sums
      // them with shuffles
      const int nq = dv >> 2;
      const int tpp = nq >= 32 ? 32 : nq;
      const int G = (nq < 32 && 32 % nq == 0) ? 32 / nq : 1;
      const int g = lane / tpp, q0 = lane - g * tpp;
      for (int k = 0; k * tpp < nq; ++k) {   // the same count on every lane
        const int qi = q0 + k * tpp;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        if (g < G && qi < nq) {
          const TKV* col = vr + 4 * qi;
#pragma unroll 4
          for (int s = g; s < n; s += G) {
            const float ps = p[s];
            const Vec4 x = load4(col + s * v_s1);
            a[0] += ps * x.x;
            a[1] += ps * x.y;
            a[2] += ps * x.z;
            a[3] += ps * x.w;
          }
        }
        for (int off = tpp; off < tpp * G; off <<= 1)
#pragma unroll
          for (int j = 0; j < 4; ++j) a[j] += __shfl_xor_sync(0xffffffffu, a[j], off);
        if (g == 0 && qi < nq) {
#pragma unroll
          for (int j = 0; j < 4; ++j) o[4 * qi + j] = from_f32<TQ>(a[j]);
        }
      }
    }
    __syncwarp();   // the next row reuses qs and p
  }
}

template <typename TQ, typename TKV, bool VT>
int rows_launch(const void* q, const void* kt, const void* ks, const void* v, const void* vs,
                const void* lengths, void* out, long long E, long long dk, long long S,
                long long dv, long long scalar_len, long long rows, long long warps,
                long long q_se, long long kt_se, long long kt_sd, long long v_se,
                long long v_s1, long long ks_se, long long vs_se, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(warps) * (dk + S) * sizeof(float);
  auto kern = rows_kernel<TQ, TKV, VT>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  const unsigned blocks = static_cast<unsigned>((E + rows - 1) / rows);
  kern<<<blocks, static_cast<unsigned>(32 * warps), smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kt), static_cast<const float*>(ks),
      static_cast<const TKV*>(v), static_cast<const float*>(vs),
      static_cast<const int*>(lengths), static_cast<TQ*>(out), static_cast<int>(E),
      static_cast<int>(dk), static_cast<int>(S), static_cast<int>(dv),
      static_cast<int>(scalar_len), static_cast<int>(rows), q_se, kt_se, kt_sd, v_se, v_s1,
      ks_se, vs_se);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int rows_dispatch(bool vt, const void* q, const void* kt, const void* ks, const void* v,
                  const void* vs, const void* lengths, void* out, long long E, long long dk,
                  long long S, long long dv, long long scalar_len, long long rows,
                  long long warps, long long q_se, long long kt_se, long long kt_sd,
                  long long v_se, long long v_s1, long long ks_se, long long vs_se,
                  cudaStream_t stream) {
#define ROWS_ARGS q, kt, ks, v, vs, lengths, out, E, dk, S, dv, scalar_len, rows, warps, q_se, \
                  kt_se, kt_sd, v_se, v_s1, ks_se, vs_se, stream
  return vt ? rows_launch<TQ, TKV, true>(ROWS_ARGS) : rows_launch<TQ, TKV, false>(ROWS_ARGS);
#undef ROWS_ARGS
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

// The selector (v_transposed = 1, values (E, dv, S)) and blockdiag
// (v_transposed = 0, values (E, S, dv)) forms.
extern "C" int decode_attention_rows_launch(
    const void* q, const void* kt, const void* ks, const void* v, const void* vs,
    const void* lengths, void* out, long long E, long long dk, long long S, long long dv,
    long long scalar_len, long long rows, long long warps, long long v_transposed,
    long long q_se, long long kt_se, long long kt_sd, long long v_se, long long v_s1,
    long long ks_se, long long vs_se, long long q_dtype, long long kv_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vt = v_transposed != 0;
#define R_ARGS vt, q, kt, ks, v, vs, lengths, out, E, dk, S, dv, scalar_len, rows, warps, q_se, \
               kt_se, kt_sd, v_se, v_s1, ks_se, vs_se, st
  if (q_dtype == DT_BF16 && kv_dtype == DT_I8) return rows_dispatch<__nv_bfloat16, int8_t>(R_ARGS);
  if (q_dtype == DT_BF16 && kv_dtype == DT_BF16)
    return rows_dispatch<__nv_bfloat16, __nv_bfloat16>(R_ARGS);
  if (q_dtype == DT_F32 && kv_dtype == DT_I8) return rows_dispatch<float, int8_t>(R_ARGS);
  if (q_dtype == DT_F32 && kv_dtype == DT_F32) return rows_dispatch<float, float>(R_ARGS);
#undef R_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
