// K1: single-query decode attention over (possibly INT8) flat-E caches.
//
// Replaces the TPU kernel backpacks_flash_attn_tpu/ops/decode_attention.py
// decode_attention_fused (:77, Pallas body _kernel :43), whose contract the
// TPU's shipped XLA contraction decode_attention_flat (:134) shares:
//   out[e] = softmax_{s < len[e]}((q[e] . kt[e,:,s]) * ks[e,s]) * vs[e,s] @ v[e,s,:]
//
// Bound on the H100: memory. Each row reads its key prefix (dk x len) and
// value prefix (len x dv) once, at stored precision (int8 = 1 byte); the
// work is ~2 flops per byte, far below the card's ~295 flop/byte ridge.
// Design: one 256-thread block per row e (E = batch * heads gives >= 1536
// blocks at the main path, enough to fill 132 SMs). Scores stream kt with
// threads along s (coalesced in the (E, dk, S) layout), are kept in shared
// memory, softmaxed with block reductions, then the value prefix streams
// with threads along dv, 4 elements per thread per load, s split across
// thread groups when dv is small (GPT dv = 64) and summed in shared memory.
// int8 is dequantized in registers; all arithmetic is f32. Only positions
// below the row's length are read, so a window slice of the cache costs no
// copy and the early steps of a long window read little.
//
// The (m, l) form (mo, lo non-null; counted apart as decode_attention_ml) also
// writes each row's softmax state for the staged serving decode, which merges
// this main segment with a short segment over the staging block
// (merge_softmax_segments, decode_attention.py:1270): m = the row max of the
// valid scores, in the units of the scores above, and l = sum exp(s - m) over
// the same positions, so that out * l is the unnormalized segment. A row with
// no valid position returns (0, NEG, 0), as stage_segment_attention does, and
// the merge weighs it out.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;   // decode_attention.py NEG

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kt,
                        const float* __restrict__ ks, const TKV* __restrict__ v,
                        const float* __restrict__ vs, const int* __restrict__ lengths,
                        TQ* __restrict__ out, float* __restrict__ mo, float* __restrict__ lo,
                        int dk, int S, int dv, int scalar_len,
                        long long q_se, long long kt_se, long long kt_sd, long long v_se,
                        long long v_ss, long long ks_se, long long vs_se) {
  extern __shared__ float smem[];
  float* qs = smem;        // [dk]
  float* p = qs + dk;      // [S] scores, then probabilities
  float* red = p + S;      // [32] reduction scratch
  float* part = red + 32;  // [groups * dv] partial outputs

  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const int len = lengths != nullptr ? lengths[e] : scalar_len;
  // an empty row attends uniformly over all S columns, as the masked
  // softmax of the reference does when every score is NEG
  const bool empty = len <= 0;
  const int n = empty ? S : min(len, S);
  if (empty && mo != nullptr) {   // the (m, l) form: an empty segment
    for (int d = tid; d < dv; d += kThreads)
      out[static_cast<long long>(e) * dv + d] = from_f32<TQ>(0.f);
    if (tid == 0) {
      mo[e] = kNeg;
      lo[e] = 0.f;
    }
    return;
  }

  for (int d = tid; d < dk; d += kThreads) qs[d] = to_f32(q[e * q_se + d]);
  __syncthreads();

  // phase 1: scores, threads along s
  const TKV* ktr = kt + e * kt_se;
  float local_max = -INFINITY;
  for (int s = tid; s < n; s += kThreads) {
    float acc = 0.f;
    if (!empty) {
#pragma unroll 8
      for (int d = 0; d < dk; ++d) acc += qs[d] * to_f32(ktr[d * kt_sd + s]);
      if (ks != nullptr) acc *= ks[e * ks_se + s];
    }
    p[s] = acc;
    local_max = fmaxf(local_max, acc);
  }
  const float m = block_max(local_max, red);
  float local_sum = 0.f;
  for (int s = tid; s < n; s += kThreads) {
    const float x = expf(p[s] - m);
    p[s] = x;
    local_sum += x;
  }
  const float tot = block_sum(local_sum, red);
  const float inv = 1.f / tot;
  if (mo != nullptr && tid == 0) {
    mo[e] = m;
    lo[e] = tot;
  }
  for (int s = tid; s < n; s += kThreads)
    p[s] = p[s] * inv * (vs != nullptr ? vs[e * vs_se + s] : 1.f);
  __syncthreads();

  // phase 2: out = p @ v, threads along dv (4 per thread), s across groups
  const int tpg = dv >> 2;
  const int groups = kThreads / tpg;
  const int g = tid / tpg;
  const int c = (tid - g * tpg) * 4;
  if (g < groups) {
    const TKV* vr = v + e * v_se + c;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
    for (int s = g; s < n; s += groups) {
      const float ps = p[s];
      const Vec4 x = load4(vr + s * v_ss);
      a0 += ps * x.x;
      a1 += ps * x.y;
      a2 += ps * x.z;
      a3 += ps * x.w;
    }
    float* pr = part + g * dv + c;
    pr[0] = a0;
    pr[1] = a1;
    pr[2] = a2;
    pr[3] = a3;
  }
  __syncthreads();
  for (int d = tid; d < dv; d += kThreads) {
    float acc = 0.f;
    for (int gg = 0; gg < groups; ++gg) acc += part[gg * dv + d];
    out[static_cast<long long>(e) * dv + d] = from_f32<TQ>(acc);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kt, const void* ks, const void* v, const void* vs,
           const void* lengths, void* out, void* mo, void* lo, long long E, long long dk,
           long long S, long long dv, long long scalar_len, long long q_se, long long kt_se,
           long long kt_sd, long long v_se, long long v_ss, long long ks_se, long long vs_se,
           cudaStream_t stream) {
  const long long groups = kThreads / (dv / 4);
  const size_t smem = static_cast<size_t>(dk + S + 32 + groups * dv) * sizeof(float);
  decode_attention_kernel<TQ, TKV><<<static_cast<unsigned>(E), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kt), static_cast<const float*>(ks),
      static_cast<const TKV*>(v), static_cast<const float*>(vs),
      static_cast<const int*>(lengths), static_cast<TQ*>(out), static_cast<float*>(mo),
      static_cast<float*>(lo), static_cast<int>(dk),
      static_cast<int>(S), static_cast<int>(dv), static_cast<int>(scalar_len), q_se, kt_se,
      kt_sd, v_se, v_ss, ks_se, vs_se);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int decode_attention_launch(const void* q, const void* kt, const void* ks,
                                       const void* v, const void* vs, const void* lengths,
                                       void* out, void* mo, void* lo, long long E,
                                       long long dk, long long S,
                                       long long dv, long long scalar_len, long long q_se,
                                       long long kt_se, long long kt_sd, long long v_se,
                                       long long v_ss, long long ks_se, long long vs_se,
                                       long long q_dtype, long long kv_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K1_ARGS q, kt, ks, v, vs, lengths, out, mo, lo, E, dk, S, dv, scalar_len, q_se, kt_se, \
                kt_sd, v_se, v_ss, ks_se, vs_se, st
  if (q_dtype == DT_BF16 && kv_dtype == DT_I8) return launch<__nv_bfloat16, int8_t>(K1_ARGS);
  if (q_dtype == DT_BF16 && kv_dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(K1_ARGS);
  if (q_dtype == DT_F32 && kv_dtype == DT_I8) return launch<float, int8_t>(K1_ARGS);
  if (q_dtype == DT_F32 && kv_dtype == DT_F32) return launch<float, float>(K1_ARGS);
#undef K1_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
