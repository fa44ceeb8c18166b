// K3: FlashAttention forward: online softmax over key tiles, with
// attention dropout.
//
// Replaces the TPU kernel backpacks_flash_attn_tpu/ops/flash_attention.py
// _flash_fwd (:298, Pallas body _flash_fwd_kernel :158) for causal masking,
// per-sequence seq_lengths and q_offsets. q is (B, sq, H, 64), k and v are
// (B, sk, H, 64), each with any (batch, row, head) strides. Key u of
// sequence b is valid for query row i when u < min(seq_len[b], sk) and, if
// causal, u <= q_off[b] + i. Fully masked rows give 0 (l = 0 is treated as
// 1) and an LSE of FLASH_NEG_INF, as on the TPU. out is (B, sq, H, 64),
// contiguous, in the input's dtype; lse is (B, H, sq) f32. Dropout
// (common.cuh dropout_keep, positions q_off[b] + i and u, stream b * H + h)
// scales the kept un-normalised probabilities by 1 / (1 - p) after the
// running max and sum are taken, so the LSE stays the pre-dropout one the
// backward (K5) recomputes from.
//
// Bound on the H100: at the training shape (32 x 12 x 512, causal) the
// bytes of q, k, v and out (0.03 ms) against 6.4 GFLOP (0.007 ms); at long
// sequences the flops of the two products over the causal half (s 8192:
// 2.1e11, 0.21 ms at 989 TFLOP/s); at the serve prefill (sq = 32 over the
// first 32 columns of a cache) the bytes.
//
// bf16 with 16-byte aligned rows and scale > 0 (the tensor-core route):
// one block of WARPS warps per (query tile, head, batch row); a warp owns
// MT groups of 16 query rows. The launcher takes 64-row tiles (4 warps of
// 16 rows) up to sq 1024: at the training and forward shapes more, shorter
// blocks beat longer ones. Past that (bound by the products) 128-row
// tiles of 4 warps of 32 rows, so every K and V fragment a warp reads from
// shared memory feeds two products. The serve prefill's sq = 32 takes 2
// warps, so no warp of it idles. The body lives in flash_attention.cuh,
// which K9's forward shares over its own walk of the key tiles: S = Q K^T
// and O += P V on mma.sync m16n8k16 (bf16 in, f32 accumulators; K's B
// fragments by ldmatrix, V's by
// ldmatrix.trans; Q's A fragments by ldmatrix from shared memory each tile
// at MT = 1, held in registers at MT = 2), the online softmax per
// accumulator half in registers (max of the raw scores as a tree, 2^x of
// one fma in one MUFU instruction, scale * log2 e), P made in 16-key
// chunks, each turned into an A fragment and multiplied into O without
// touching shared memory. Dropout is a template argument, so neither form
// branches inside a tile; it is decided per fragment element at its (row,
// key) = (q0 + 16 * MT * warp + 16 * mt + g + 8 * half, j0 + 8 * nf + 2 *
// tq + e): a dropped probability is zeroed after the sum, and the
// 1 / (1 - p) of the kept ones scales O once at the end. 64-key K/V tiles
// stream through a kStages-deep cp.async ring (tile t + 1 loads while
// tile t multiplies), one barrier a tile; rows at or past the sequence's
// valid length are zero-filled without a read. A block walks key tiles
// only up to the last key any of its rows may see (causal and length
// limits); a warp skips the products of tiles past its own rows' limit,
// applies the mask (-inf) only on tiles that straddle the diagonal or the
// length, and a warp whose rows all lie past sq does no products. Query
// tiles with the most keys launch first (reverse blockIdx.y), so the
// causal tail does not leave SMs idle. Head dim 64 is a compile-time
// constant (a template argument once other head dims come). Out of scope
// in this version: wgmma, TMA and warp specialisation.
//
// f32 operands (no bf16 tensor-core form), bf16 operands whose rows or
// head offsets are not 16-byte aligned (cp.async needs 16 bytes) and a
// scale <= 0 take the SIMT loop: one 256-thread block per 64-row query
// tile, Q staged once in shared memory as f32, 32-key K/V tiles staged as
// f32, four threads a query row (8 scores each, reduced across the four
// lanes with shuffles; 16 of the 64 output columns as f32 accumulators in
// registers). The launcher decides the route once per call.
#include "flash_attention.cuh"

namespace {

bool aligned16(const void* p, long long sb, long long st, long long sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 && st % 8 == 0 && sh % 8 == 0;
}

// ------------------------------------------------------------ SIMT (f32, unaligned bf16)

constexpr int BQ_SIMT = 64, BKV_SIMT = 32, kSimtThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kSimtThreads)
flash_fwd_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                      const int* __restrict__ seq_lengths, const int* __restrict__ q_offsets,
                      int H, int sq, int sk, long long q_sb, long long q_st, long long q_sh,
                      long long k_sb, long long k_st, long long k_sh, long long v_sb,
                      long long v_st, long long v_sh, float scale, int causal,
                      DropoutParams drop) {
  __shared__ float Qs[BQ_SIMT][D + 1];
  __shared__ float Ks[BKV_SIMT][D + 1];
  __shared__ float Vs[BKV_SIMT][D];
  __shared__ float Ps[BQ_SIMT][BKV_SIMT + 1];

  const int q0 = blockIdx.x * BQ_SIMT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid >> 2, c = tid & 3;  // query row in the tile, lane in its group of 4
  const int kv_len = seq_lengths ? min(seq_lengths[b], sk) : sk;  // NULL: sk and 0
  const int q_off = q_offsets ? q_offsets[b] : 0;
  const int qi = q0 + r;                // query row index
  const int q_pos = q_off + qi;         // its absolute position

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  for (int idx = tid; idx < BQ_SIMT * D; idx += kSimtThreads) {
    const int rr = idx / D, dd = idx % D;
    Qs[rr][dd] = q0 + rr < sq ? to_f32(qb[(q0 + rr) * q_st + dd]) : 0.f;
  }

  // keys past this bound are masked for every row of the tile
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, q_off + q0 + BQ_SIMT);

  float m = FLASH_NEG_INF, l = 0.f;
  float o[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) o[j] = 0.f;

  for (int j0 = 0; j0 < kv_end; j0 += BKV_SIMT) {
    __syncthreads();  // previous tile fully consumed (and Q staged)
    for (int idx = tid; idx < BKV_SIMT * D; idx += kSimtThreads) {
      const int rr = idx / D, dd = idx % D;
      const bool in = j0 + rr < sk;
      Ks[rr][dd] = in ? to_f32(kb[(j0 + rr) * k_st + dd]) : 0.f;
      Vs[rr][dd] = in ? to_f32(vb[(j0 + rr) * v_st + dd]) : 0.f;
    }
    __syncthreads();

    float s[BKV_SIMT / 4];
    float tile_max = FLASH_NEG_INF;
#pragma unroll
    for (int i = 0; i < BKV_SIMT / 4; ++i) {
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
    for (int i = 0; i < BKV_SIMT / 4; ++i) {
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
    for (int kk = 0; kk < BKV_SIMT; ++kk) {
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
int launch_simt(const void* q, const void* k, const void* v, void* out, void* lse,
                const void* seq_lengths, const void* q_offsets, long long B, long long H,
                long long sq, long long sk, long long q_sb, long long q_st, long long q_sh,
                long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
                long long v_sh, float scale, long long causal, DropoutParams drop,
                cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((sq + BQ_SIMT - 1) / BQ_SIMT), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  flash_fwd_simt_kernel<T><<<grid, kSimtThreads, 0, stream>>>(
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
  if (B * H * sq == 0) return 0;
  const DropoutParams drop = make_dropout(seed0, seed1, thr, inv_keep, dropout);
  if (dtype == DT_BF16 && scale > 0.f && aligned16(q, q_sb, q_st, q_sh) &&
      aligned16(k, k_sb, k_st, k_sh) && aligned16(v, v_sb, v_st, v_sh)) {
    const MmaArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(out),
                    static_cast<float*>(lse), static_cast<const int*>(seq_lengths),
                    static_cast<const int*>(q_offsets), static_cast<int>(H),
                    static_cast<int>(sq), static_cast<int>(sk), static_cast<int>(causal),
                    Strides{q_sb, q_st, q_sh}, Strides{k_sb, k_st, k_sh},
                    Strides{v_sb, v_st, v_sh}, scale * kLog2e, drop};
    return launch_rows<DenseKeys, true>(a, {}, k3_rows(sq), B, st);
  }
#define K3_ARGS q, k, v, out, lse, seq_lengths, q_offsets, B, H, sq, sk, q_sb, q_st, q_sh, \
                k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, causal, drop, st
  if (dtype == DT_BF16) return launch_simt<__nv_bfloat16>(K3_ARGS);
  if (dtype == DT_F32) return launch_simt<float>(K3_ARGS);
#undef K3_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
