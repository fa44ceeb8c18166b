// K8: single-query decode attention over the low-bit (int4 pair-packed) caches.
//
// Replaces the TPU kernels backpacks_flash_attn_tpu/ops/decode_attention.py
// decode_attention_int4_blockdiag (:667, _blockdiag_int4_kernel :658),
// decode_attention_mixed_blockdiag (:808, _blockdiag_mixed_kernel :796) and the stacked
// forms behind _stacked_call (:933; _stacked_int4_kernel :892, _stacked_mixed_kernel :911),
// which all run _lowbit_decode_body (:567). For each row e, with packed column j holding
// positions 2j (low nibble) and 2j+1 (high nibble):
//   s_even[j] = (q . k_lo[:, j]) * ks2[e, 0, j]    for 2j   < len
//   s_odd[j]  = (q . k_hi[:, j]) * ks2[e, 1, j]    for 2j+1 < len
//   p = one softmax over both score vectors together
//   out = sum_j p_even[j] vs2[e, 0, j] v_lo[j, :] + p_odd[j] vs2[e, 1, j] v_hi[j, :]
// Two key formats, one template: pair-packed nibbles (kSplit = false, kt4 (E, dk, S/2)) and
// int8 in the even/odd split layout (kSplit = true, k8 (E, dk, 2, S/2), the mixed Backpack
// cache). Values are always pair-packed (E, S/2, dv); scales (E, 2, S/2) f32.
//
// Bound on the H100: memory. A valid position costs dk/2 + dv/2 bytes of packed cache (dk
// for split int8 keys) plus 8 bytes of scales, read once at about 2 flops a byte.
// Design: K1's (csrc/decode_attention.cu), not the TPU's block-diagonal matrix-unit trick:
// one 256-thread block per row (E = batch * heads >= 1536 blocks on the main path). Scores
// stream the key bytes with threads along packed columns, both halves of a byte at once,
// a short row's dk rows split over up to 8 threads a column so that no thread waits on a
// long chain of loads, into shared memory; the joint softmax uses block reductions; then
// the value bytes stream with threads along dv, 16 bytes (32 nibbles, 16 channels x 2
// positions) a load, packed columns split across thread groups and summed in shared
// memory. Nibbles are sign-extended in registers, all arithmetic is f32. Only the valid
// packed prefix ceil(len / 2) is read, and every operand is addressed through its strides,
// so a layer view of a stacked cache and a window slice cost no copy.
//
// K8-ml, the (m, l) form (mo, lo non-null), replaces _stacked_call(return_ml=True) (:990,
// _stacked_int4_ml_kernel :922, the mo_ref/lo_ref epilogue of _lowbit_decode_body :651)
// behind decode_attention_int4_staged_ml (:1205): the main segment of the staged low-bit
// serving decode, valid below base_len, merged with a segment over the int8 staging block.
// It also writes each row's softmax state: m = the max over the valid scores of BOTH
// parities (taken before any exp), l = sum exp(s - m) over the same positions with that
// same m, in the units of the scores above. A row with no valid position returns
// (0, NEG, 0), as the Pallas body does, and the merge weighs it out.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;    // value bytes per thread per load (one uint4)
constexpr int kBatch = 8;   // key rows loaded before they are used
constexpr int kMaxSplit = 8;
constexpr float kNeg = -1e30f;  // decode_attention.py NEG

// nibble n (0 = lowest) of a 32-bit word, sign-extended
__device__ __forceinline__ float nibble(uint32_t w, int n) {
  return static_cast<float>(static_cast<int>(w << (28 - 4 * n)) >> 28);
}

__device__ __forceinline__ float nib_lo(int8_t b) {
  return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(b) << 4) >> 4);
}

__device__ __forceinline__ float nib_hi(int8_t b) { return static_cast<float>(b >> 4); }

// acc[c] += we * even-position value + wo * odd-position value, channels c of one word
__device__ __forceinline__ void accumulate4(float* acc, uint32_t w, float we, float wo) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += we * nibble(w, 2 * i) + wo * nibble(w, 2 * i + 1);
}

template <typename TQ, bool kSplit>
__global__ void __launch_bounds__(kThreads)
lowbit_decode_kernel(const TQ* __restrict__ q, const int8_t* __restrict__ keys,
                     const float* __restrict__ ks2, const int8_t* __restrict__ v4,
                     const float* __restrict__ vs2, const int* __restrict__ lengths,
                     TQ* __restrict__ out, float* __restrict__ mo, float* __restrict__ lo,
                     int dk, int S2, int dv, int scalar_len,
                     long long q_se, long long k_se, long long k_sd, long long k_sp,
                     long long ks_se, long long ks_sp, long long v_se, long long v_ss,
                     long long vs_se, long long vs_sp) {
  extern __shared__ float smem[];
  float* qs = smem;        // [dk]
  float* pe = qs + dk;     // [S2] even-position scores, then weights
  float* po = pe + S2;     // [S2] odd-position scores, then weights
  float* red = po + S2;    // [32] reduction scratch
  float* part = red + 32;  // [max(groups * dv, 2 * kThreads)] partial sums

  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const int len = lengths != nullptr ? lengths[e] : scalar_len;
  // an empty row attends uniformly over all 2 * S2 positions, as the masked
  // softmax of the plain version does when every score is NEG
  const bool empty = len <= 0;
  const int n2 = empty ? S2 : min((len + 1) >> 1, S2);  // packed columns read
  const int n_odd = empty ? S2 : min(len >> 1, S2);     // columns whose odd half is valid
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

  // phase 1: both halves' scores. The key bytes are read a column per thread
  // (neighbouring threads on neighbouring columns); when the row is short,
  // each column's dk rows split over dsplit threads, so that every thread's
  // chain of dependent loads stays short, and kBatch rows are loaded before
  // any is used.
  int dsplit = 1;
  while (dsplit < kMaxSplit && 2 * dsplit * n2 <= kThreads && dk % (2 * dsplit) == 0)
    dsplit *= 2;
  const int ncol = kThreads / dsplit, dlen = dk / dsplit;
  const int jc = tid % ncol, ds = tid / ncol;
  const int8_t* kr = keys + e * k_se + ds * dlen * k_sd;
  const float* qd = qs + ds * dlen;
  const float* ksr = ks2 + e * ks_se;
  float* part_e = part;
  float* part_o = part + kThreads;
  float local_max = -INFINITY;
  for (int j0 = 0; j0 < n2; j0 += ncol) {
    const int j = j0 + jc;
    float ae = 0.f, ao = 0.f;
    if (j < n2 && !empty) {
      for (int d0 = 0; d0 < dlen; d0 += kBatch) {
        int8_t b[kBatch], b2[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const bool ok = d0 + u < dlen;
          b[u] = ok ? kr[(d0 + u) * k_sd + j] : 0;
          if constexpr (kSplit) b2[u] = ok ? kr[(d0 + u) * k_sd + k_sp + j] : 0;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const float x = d0 + u < dlen ? qd[d0 + u] : 0.f;
          if constexpr (kSplit) {
            ae += x * static_cast<float>(b[u]);
            ao += x * static_cast<float>(b2[u]);
          } else {
            ae += x * nib_lo(b[u]);
            ao += x * nib_hi(b[u]);
          }
        }
      }
    }
    part_e[tid] = ae;
    part_o[tid] = ao;
    __syncthreads();
    if (ds == 0 && j < n2) {
      float se = 0.f, so = 0.f;
      for (int t = 0; t < dsplit; ++t) {
        se += part_e[t * ncol + jc];
        so += part_o[t * ncol + jc];
      }
      if (!empty) {
        se *= ksr[j];
        so = j < n_odd ? so * ksr[ks_sp + j] : -INFINITY;
      }
      pe[j] = se;
      po[j] = so;
      local_max = fmaxf(local_max, fmaxf(se, so));
    }
    __syncthreads();
  }
  const float m = block_max(local_max, red);
  float local_sum = 0.f;
  for (int j = tid; j < n2; j += kThreads) {
    const float xe = expf(pe[j] - m), xo = expf(po[j] - m);
    pe[j] = xe;
    po[j] = xo;
    local_sum += xe + xo;
  }
  const float tot = block_sum(local_sum, red);
  const float inv = 1.f / tot;
  if (mo != nullptr && tid == 0) {
    mo[e] = m;
    lo[e] = tot;
  }
  const float* vsr = vs2 + e * vs_se;
  for (int j = tid; j < n2; j += kThreads) {
    pe[j] *= inv * vsr[j];
    po[j] *= inv * vsr[vs_sp + j];
  }
  __syncthreads();

  // phase 2: out = p_even @ v_lo + p_odd @ v_hi, threads along dv (kVec channels
  // each, 16 bytes a load), packed columns across groups
  const int tpg = dv / kVec;
  const int groups = kThreads / tpg;
  const int g = tid / tpg;
  const int c = (tid - g * tpg) * kVec;
  if (g < groups) {
    const int8_t* vr = v4 + e * v_se + c;
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int j = g; j < n2; j += groups) {
      const float we = pe[j], wo = po[j];
      const uint4 raw = *reinterpret_cast<const uint4*>(vr + j * v_ss);
      accumulate4(acc, raw.x, we, wo);
      accumulate4(acc + 4, raw.y, we, wo);
      accumulate4(acc + 8, raw.z, we, wo);
      accumulate4(acc + 12, raw.w, we, wo);
    }
    float* pr = part + g * dv + c;
#pragma unroll
    for (int i = 0; i < kVec; ++i) pr[i] = acc[i];
  }
  __syncthreads();
  for (int d = tid; d < dv; d += kThreads) {
    float acc = 0.f;
    for (int gg = 0; gg < groups; ++gg) acc += part[gg * dv + d];
    out[static_cast<long long>(e) * dv + d] = from_f32<TQ>(acc);
  }
}

template <typename TQ, bool kSplit>
int launch(const void* q, const void* keys, const void* ks2, const void* v4, const void* vs2,
           const void* lengths, void* out, void* mo, void* lo, long long E, long long dk,
           long long S2, long long dv, long long scalar_len, long long q_se, long long k_se,
           long long k_sd, long long k_sp, long long ks_se, long long ks_sp, long long v_se,
           long long v_ss, long long vs_se, long long vs_sp, cudaStream_t stream) {
  const long long groups = kThreads / (dv / kVec);
  const long long part = groups * dv > 2 * kThreads ? groups * dv : 2 * kThreads;
  const size_t smem = static_cast<size_t>(dk + 2 * S2 + 32 + part) * sizeof(float);
  lowbit_decode_kernel<TQ, kSplit><<<static_cast<unsigned>(E), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const int8_t*>(keys),
      static_cast<const float*>(ks2), static_cast<const int8_t*>(v4),
      static_cast<const float*>(vs2), static_cast<const int*>(lengths), static_cast<TQ*>(out),
      static_cast<float*>(mo), static_cast<float*>(lo), static_cast<int>(dk),
      static_cast<int>(S2), static_cast<int>(dv), static_cast<int>(scalar_len), q_se, k_se,
      k_sd, k_sp, ks_se, ks_sp, v_se, v_ss, vs_se, vs_sp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lowbit_decode_attention_launch(
    const void* q, const void* keys, const void* ks2, const void* v4, const void* vs2,
    const void* lengths, void* out, void* mo, void* lo, long long E, long long dk,
    long long S2, long long dv, long long scalar_len, long long q_se, long long k_se,
    long long k_sd, long long k_sp, long long ks_se, long long ks_sp, long long v_se,
    long long v_ss, long long vs_se, long long vs_sp, long long q_dtype, long long split_keys,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K8_ARGS q, keys, ks2, v4, vs2, lengths, out, mo, lo, E, dk, S2, dv, scalar_len, q_se, \
                k_se, k_sd, k_sp, ks_se, ks_sp, v_se, v_ss, vs_se, vs_sp, st
  if (q_dtype == DT_BF16 && !split_keys) return launch<__nv_bfloat16, false>(K8_ARGS);
  if (q_dtype == DT_BF16 && split_keys) return launch<__nv_bfloat16, true>(K8_ARGS);
  if (q_dtype == DT_F32 && !split_keys) return launch<float, false>(K8_ARGS);
  if (q_dtype == DT_F32 && split_keys) return launch<float, true>(K8_ARGS);
#undef K8_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
