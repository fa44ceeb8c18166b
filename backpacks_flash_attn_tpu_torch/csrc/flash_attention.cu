// K3: FlashAttention forward: online softmax over key tiles, with
// attention dropout.
//
// Replaces the TPU kernel backpacks_flash_attn_tpu/ops/flash_attention.py
// _flash_fwd (:298, Pallas body _flash_fwd_kernel :158) for causal masking,
// per-sequence seq_lengths and q_offsets. Key u of sequence b is valid for
// query row i when u < min(seq_len[b], sk) and, if causal,
// u <= q_off[b] + i. Fully masked rows give 0 (l = 0 is treated as 1) and
// an LSE of FLASH_NEG_INF, as on the TPU. Dropout (common.cuh
// dropout_keep, positions q_off[b] + i and u, stream b * H + h) scales the
// kept un-normalised probabilities by 1 / (1 - p) after the running max and
// sum are taken, so the LSE stays the pre-dropout one the backward (K5)
// recomputes from.
//
// Bound on the H100: the flops of the two products (causal half) over the
// tensor-core rate at the main path's long sequences; the q/k/v/out bytes
// at its short cached prefill (sq = 32 over a 32-long key prefix). Design
// (first, simple version): one 256-thread block per (q-tile of 64 rows,
// head, batch). Head dim 64. Q is staged once in shared memory (f32); the
// loop walks 32-key tiles only up to the last key any row of the tile may
// see (causal and length limits), staging K and V in shared memory. Four
// threads own one query row: 8 scores each, reduced across the four lanes
// with shuffles for the running max and sum, and 16 of the 64 output
// columns as f32 accumulators in registers. The s x s score matrix never
// leaves the SM. SIMT f32 arithmetic; tensor-core products are later work.
#include "common.cuh"

namespace {

constexpr int D = 64, BQ = 64, BKV = 32, kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                       const int* __restrict__ seq_lengths, const int* __restrict__ q_offsets,
                       int H, int sq, int sk, long long q_sb, long long q_st, long long q_sh,
                       long long k_sb, long long k_st, long long k_sh, long long v_sb,
                       long long v_st, long long v_sh, float scale, int causal,
                       DropoutParams drop) {
  __shared__ float Qs[BQ][D + 1];
  __shared__ float Ks[BKV][D + 1];
  __shared__ float Vs[BKV][D];
  __shared__ float Ps[BQ][BKV + 1];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid >> 2, c = tid & 3;  // query row in the tile, lane in its group of 4
  const int kv_len = min(seq_lengths[b], sk);
  const int q_off = q_offsets[b];
  const int qi = q0 + r;                // query row index
  const int q_pos = q_off + qi;         // its absolute position

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int rr = idx / D, dd = idx % D;
    Qs[rr][dd] = q0 + rr < sq ? to_f32(qb[(q0 + rr) * q_st + dd]) : 0.f;
  }

  // keys past this bound are masked for every row of the tile
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, q_off + q0 + BQ);

  float m = FLASH_NEG_INF, l = 0.f;
  float o[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) o[j] = 0.f;

  for (int j0 = 0; j0 < kv_end; j0 += BKV) {
    __syncthreads();  // previous tile fully consumed (and Q staged)
    for (int idx = tid; idx < BKV * D; idx += kThreads) {
      const int rr = idx / D, dd = idx % D;
      const bool in = j0 + rr < sk;
      Ks[rr][dd] = in ? to_f32(kb[(j0 + rr) * k_st + dd]) : 0.f;
      Vs[rr][dd] = in ? to_f32(vb[(j0 + rr) * v_st + dd]) : 0.f;
    }
    __syncthreads();

    float s[BKV / 4];
    float tile_max = FLASH_NEG_INF;
#pragma unroll
    for (int i = 0; i < BKV / 4; ++i) {
      const int kk = c + 4 * i;
      float acc = 0.f;
#pragma unroll 16
      for (int dd = 0; dd < D; ++dd) acc += Qs[r][dd] * Ks[kk][dd];
      const int kpos = j0 + kk;
      const bool valid = kpos < kv_len && (!causal || kpos <= q_pos);
      s[i] = valid ? acc * scale : FLASH_NEG_INF;
      tile_max = fmaxf(tile_max, s[i]);
    }
    const float m_new = fmaxf(m, group_max(tile_max, 4));
    const float corr = expf(m - m_new);
    float tile_sum = 0.f;
#pragma unroll
    for (int i = 0; i < BKV / 4; ++i) {
      float p = s[i] == FLASH_NEG_INF ? 0.f : expf(s[i] - m_new);
      tile_sum += p;
      if (drop.on)
        p = dropout_keep(drop, static_cast<uint32_t>(b * H + h), static_cast<uint32_t>(q_pos),
                         static_cast<uint32_t>(j0 + c + 4 * i))
                ? p * drop.inv_keep
                : 0.f;
      Ps[r][c + 4 * i] = p;
    }
    l = l * corr + group_sum(tile_sum, 4);
    m = m_new;
#pragma unroll
    for (int j = 0; j < D / 4; ++j) o[j] *= corr;
    __syncwarp();  // the row's four lanes share one warp
#pragma unroll 8
    for (int kk = 0; kk < BKV; ++kk) {
      const float p = Ps[r][kk];
#pragma unroll
      for (int j = 0; j < D / 4; ++j) o[j] += p * Vs[kk][c + 4 * j];
    }
  }

  if (qi >= sq) return;
  const float l_safe = l == 0.f ? 1.f : l;
  const float inv = 1.f / l_safe;
  T* orow = out + ((static_cast<long long>(b) * sq + qi) * H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 4; ++j) orow[c + 4 * j] = from_f32<T>(o[j] * inv);
  if (c == 0) lse[(static_cast<long long>(b) * H + h) * sq + qi] = m + logf(l_safe);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           const void* seq_lengths, const void* q_offsets, long long B, long long H,
           long long sq, long long sk, long long q_sb, long long q_st, long long q_sh,
           long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
           long long v_sh, float scale, long long causal, DropoutParams drop,
           cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((sq + BQ - 1) / BQ), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  flash_attention_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), static_cast<const int*>(seq_lengths),
      static_cast<const int*>(q_offsets), static_cast<int>(H), static_cast<int>(sq),
      static_cast<int>(sk), q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale,
      static_cast<int>(causal), drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      void* lse, const void* seq_lengths,
                                      const void* q_offsets, long long B, long long H,
                                      long long sq, long long sk, long long q_sb,
                                      long long q_st, long long q_sh, long long k_sb,
                                      long long k_st, long long k_sh, long long v_sb,
                                      long long v_st, long long v_sh, float scale,
                                      long long causal, long long seed0, long long seed1,
                                      long long thr, float inv_keep, long long dropout,
                                      long long dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutParams drop = make_dropout(seed0, seed1, thr, inv_keep, dropout);
#define K3_ARGS q, k, v, out, lse, seq_lengths, q_offsets, B, H, sq, sk, q_sb, q_st, q_sh, \
                k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, causal, drop, st
  if (dtype == DT_BF16) return launch<__nv_bfloat16>(K3_ARGS);
  if (dtype == DT_F32) return launch<float>(K3_ARGS);
#undef K3_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
