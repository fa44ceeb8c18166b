// K9: block-sparse FlashAttention, forward (out, LSE), over only the
// (block_q, block_k) tiles a blockmask marks. The backward is
// blocksparse_attention_bwd.cu.
//
// Replaces the TPU kernel of backpacks_flash_attn_tpu/ops/flash_attention.py
// _bs_fwd (:1185, Pallas body _blocksparse_gathered_kernel :1118). The
// caller has scaled q (JAX :1439) and passes the tables of
// ops/flash_attention.py _bs_tables, built once a call on the card from the
// active mask with the causal pre-filter applied (_bs_active :1175): each
// query block's active key blocks in order and their count (JAX's tbl /
// cnt, :1197-1202), and the launch order of the query tiles. Key u of
// sequence b is valid for query row i when its tile is active, u <
// min(seq_len[b], Sk) and, if causal, u <= i. A row with no valid key
// gives 0 and an LSE of FLASH_NEG_INF, as on the TPU. Any number of blocks
// a row: the kernel reads its list from device memory.
//
// bf16 runs K3's body (flash_attention.cuh: mma.sync m16n8k16, the online
// softmax in registers, K/V through a 2-stage cp.async ring, the mask only
// on tiles that straddle the diagonal or the length) over SparseKeys, this
// file's walk of the key tiles: the query block's active key blocks, each
// split into 64-key tiles, cut at the block's last visible key. The ring
// prefetches the next tile of the list, so an inactive tile is never
// loaded. Query tiles take K3's rows (64 up to sq 1024, 128 of MT = 2 past
// it, held to a divisor of block_q: a 256-row block is two 128-row
// tiles), and the tiles with the most key tiles launch first (the order
// table, as K3's reverse blockIdx.y). f32 operands take the SIMT loop
// below (K3's f32 loop over the same lists).
//
// Bound on the H100 at chip_smoke's long-context case (b 4, s 4096, h 12,
// d 64, the band mask of bench_longctx.py: a causal 1024-position band plus
// global block 0, 256 x 256 blocks): the two products over the valid
// pairs, 1.95e8 pairs x 4 x 64 FLOP = 5.0e10, 0.0505 ms at 989 TFLOP/s,
// against 0.0303 ms of bytes (q, k, v, out and the LSE once). At s 2048 /
// 8192 (16384 tokens): 1.64e8 / 2.11e8 pairs, 0.0424 / 0.0546 ms.
#include "blocksparse_tables.cuh"
#include "flash_attention.cuh"

namespace {

// K9's walk: the query block's active key blocks (row_idx, ascending),
// each split into tpb = block_k / BK tiles; the blocks that start at or
// past kv_end (the causal limit of the tile's last row, or the keys'
// length) are a suffix of the list and are cut, and the last block kept is
// cut at kv_end
struct SparseKeys {
  struct Params {
    const int *row_idx, *row_cnt, *order;  // (n_qb, n_kb), (n_qb,), (query tiles,)
    int n_kb, block_q, block_k;
  };
  const int* list;
  int q0, n, tpb, block_k;
  __device__ __forceinline__ SparseKeys(const Params& p, const MmaArgs&, int BQ)
      : q0(p.order[blockIdx.y] * BQ), tpb(p.block_k / BK), block_k(p.block_k) {
    const int qb = q0 / p.block_q;
    list = p.row_idx + static_cast<long long>(qb) * p.n_kb;
    n = p.row_cnt[qb];
  }
  __device__ __forceinline__ int tiles(int kv_end) const {
    int lo = 0, hi = n;  // the entries whose block starts below kv_end
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (list[mid] * block_k < kv_end)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo == 0) return 0;
    return (lo - 1) * tpb + min(tpb, (kv_end - list[lo - 1] * block_k + BK - 1) / BK);
  }
  __device__ __forceinline__ int key0(int t) const {
    return list[t / tpb] * block_k + (t % tpb) * BK;
  }
};

// ------------------------------------------------------------- f32 (SIMT)

struct SimtShape {
  int H, Sq, Sk, n_kb, block_q, block_k, causal;
  float scale;
};

// one 256-thread block per (64-query tile, head, batch row); four threads a
// row, each making 8 of its 32 scores per key tile and holding D / 4 of its
// D output columns (K3's loop and tiles, flash_attention.cuh)
template <int D>
__global__ void __launch_bounds__(kSimtThreads)
fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
                const int* __restrict__ row_idx, const int* __restrict__ row_cnt,
                const int* __restrict__ seq_lengths, SimtShape sh, Strides sq, Strides sk,
                Strides sv) {
  constexpr bool kStatic = kSimtStatic<D>;
  __shared__ float Qs_s[kStatic ? BQ_SIMT : 1][D + 1];
  __shared__ float Ks_s[kStatic ? BKV_SIMT : 1][D + 1];
  __shared__ float Vs_s[kStatic ? BKV_SIMT : 1][D];
  __shared__ float Ps[BQ_SIMT][BKV_SIMT + 1];
  float(*Qs)[D + 1] = Qs_s;
  float(*Ks)[D + 1] = Ks_s;
  float(*Vs)[D] = Vs_s;
  if constexpr (!kStatic) {
    DynRows dyn;
    Qs = dyn.take<D + 1>(BQ_SIMT);
    Ks = dyn.take<D + 1>(BKV_SIMT);
    Vs = dyn.take<D>(BKV_SIMT);
  }
  const int q0 = blockIdx.x * BQ_SIMT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3, qi = q0 + r;
  const int kv_len = seq_lengths ? min(seq_lengths[b], sh.Sk) : sh.Sk;
  const int qb = q0 / sh.block_q;
  const int* list = row_idx + static_cast<long long>(qb) * sh.n_kb;
  const int n_act = row_cnt[qb];
  const float* qp = q + b * sq.sb + h * sq.sh;
  const float* kp = k + b * sk.sb + h * sk.sh;
  const float* vp = v + b * sv.sb + h * sv.sh;
  for (int idx = tid; idx < BQ_SIMT * D; idx += kSimtThreads) {
    const int rr = idx / D, dd = idx % D;
    Qs[rr][dd] = q0 + rr < sh.Sq ? qp[(q0 + rr) * sq.st + dd] : 0.f;
  }
  const int kv_end = sh.causal ? min(kv_len, q0 + BQ_SIMT) : kv_len;
  float m = FLASH_NEG_INF, l = 0.f;
  float o[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) o[j] = 0.f;

  for (int i = 0; i < n_act; ++i) {
    const int j_lo = list[i] * sh.block_k, j_hi = min(j_lo + sh.block_k, kv_end);
    for (int j0 = j_lo; j0 < j_hi; j0 += BKV_SIMT) {
      __syncthreads();  // previous tile fully consumed (and Q staged)
      for (int idx = tid; idx < BKV_SIMT * D; idx += kSimtThreads) {
        const int rr = idx / D, dd = idx % D;
        const bool in = j0 + rr < sh.Sk;
        Ks[rr][dd] = in ? kp[(j0 + rr) * sk.st + dd] : 0.f;
        Vs[rr][dd] = in ? vp[(j0 + rr) * sv.st + dd] : 0.f;
      }
      __syncthreads();
      float s[BKV_SIMT / 4];
      float tile_max = FLASH_NEG_INF;
#pragma unroll
      for (int t = 0; t < BKV_SIMT / 4; ++t) {
        const int kk = c + 4 * t, key = j0 + kk;
        float acc = 0.f;
#pragma unroll 16
        for (int dd = 0; dd < D; ++dd) acc += Qs[r][dd] * Ks[kk][dd];
        const bool valid = key < kv_len && (!sh.causal || key <= qi);
        s[t] = valid ? acc * sh.scale : FLASH_NEG_INF;
        tile_max = fmaxf(tile_max, s[t]);
      }
      const float m_new = fmaxf(m, group_max(tile_max, 4));
      const float corr = expf(m - m_new);
      float tile_sum = 0.f;
#pragma unroll
      for (int t = 0; t < BKV_SIMT / 4; ++t) {
        const float p = s[t] == FLASH_NEG_INF ? 0.f : expf(s[t] - m_new);
        tile_sum += p;
        Ps[r][c + 4 * t] = p;
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
  }
  if (qi >= sh.Sq) return;
  const float l_safe = l == 0.f ? 1.f : l;
  const float inv = 1.f / l_safe;
  float* orow = out + ((static_cast<long long>(b) * sh.Sq + qi) * sh.H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 4; ++j) orow[c + 4 * j] = o[j] * inv;
  if (c == 0) lse[(static_cast<long long>(b) * sh.H + h) * sh.Sq + qi] = m + logf(l_safe);
}

template <int D>
cudaError_t launch_simt(const float* q, const float* k, const float* v, float* out, float* lse,
                        const int* row_idx, const int* row_cnt, const int* seq_lengths,
                        const SimtShape& sh, long long B, Strides sq, Strides sk, Strides sv,
                        cudaStream_t st) {
  const size_t smem = kSimtStatic<D> ? 0 : 4 * kSimtDynFloats<D>;
  if (smem > 0) {
    const cudaError_t err = allow_smem<fwd_simt_kernel<D>>(smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>((sh.Sq + BQ_SIMT - 1) / BQ_SIMT),
                  static_cast<unsigned>(sh.H), static_cast<unsigned>(B));
  fwd_simt_kernel<D><<<grid, kSimtThreads, smem, st>>>(q, k, v, out, lse, row_idx, row_cnt,
                                                       seq_lengths, sh, sq, sk, sv);
  return cudaGetLastError();
}

}  // namespace

// q (B, sq, H, d), k and v (B, sk, H, d), d 64, 80, 96 or 128, bf16 or f32
// (dtype) with the given (batch, row, head) strides, bf16 rows 16-byte
// aligned; seq_lengths (B,) int32 or NULL (sk) -> out (B, sq, H, d)
// contiguous, lse (B, H, sq) f32. The tables (int32): row_idx (n_qb, n_kb)
// and row_cnt (n_qb,), each query block's active key blocks first in
// order; col_idx (n_kb, n_qb) and col_cnt (n_kb,), each key block's;
// fwd_order (ceil(sq / rows),) and bwd_order (ceil(sk / key_tile),), the
// CTAs of the forward (query tiles of `rows` rows: 32, 64 or 128 at d 64,
// 32 or 64 past it, dividing block_q) and of the backward (key
// tiles of key_tile keys) in launch order. They are built here first,
// from mask (n_qb, n_kb) int32 (blocksparse_tables.cuh; work: ceil(sq /
// rows) + ceil(sk / key_tile) int32 of scratch), and the backward reads
// them.
extern "C" int blocksparse_fwd_launch(
    const void* q, const void* k, const void* v, void* out, void* lse, const void* seq_lengths,
    const void* mask, void* row_idx, void* row_cnt, void* col_idx, void* col_cnt,
    void* fwd_order, void* bwd_order, void* work, long long B, long long H,
    long long sq, long long sk, long long n_qb, long long n_kb, long long block_q,
    long long block_k, long long rows, long long key_tile, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, float scale, long long causal, long long d, long long dtype,
    void* stream) {
  if (block_q % BK || block_k % BK || block_q <= 0 || block_k <= 0 || block_q % rows ||
      block_k % key_tile)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B * H * sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* ri = static_cast<const int*>(row_idx);
  const auto* rc = static_cast<const int*>(row_cnt);
  const TableArgs t{static_cast<const int*>(mask), static_cast<int>(n_qb),
                    static_cast<int>(n_kb), static_cast<int>(sq), static_cast<int>(sk),
                    static_cast<int>(block_q), static_cast<int>(block_k),
                    static_cast<int>(rows), static_cast<int>(key_tile),
                    static_cast<int>(causal), static_cast<int*>(row_idx),
                    static_cast<int*>(row_cnt), static_cast<int*>(col_idx),
                    static_cast<int*>(col_cnt), static_cast<int*>(fwd_order),
                    static_cast<int*>(bwd_order), static_cast<int*>(work),
                    static_cast<int>((sq + rows - 1) / rows),
                    static_cast<int>((sk + key_tile - 1) / key_tile)};
  const cudaError_t err = build_tables(t, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sq_{q_sb, q_st, q_sh}, sk_{k_sb, k_st, k_sh}, sv_{v_sb, v_st, v_sh};
  const auto* lp = static_cast<const int*>(seq_lengths);
  if (dtype == DT_BF16) {
    const MmaArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(out),
                    static_cast<float*>(lse), lp, nullptr, static_cast<int>(H),
                    static_cast<int>(sq), static_cast<int>(sk), static_cast<int>(causal),
                    sq_, sk_, sv_, scale * kLog2e, DropoutParams{}};
    const SparseKeys::Params wp{ri, rc, static_cast<const int*>(fwd_order),
                                static_cast<int>(n_kb), static_cast<int>(block_q),
                                static_cast<int>(block_k)};
    return with_head_dim(d, [&](auto D) {
      return launch_rows<D, SparseKeys, false>(a, wp, static_cast<int>(rows), B, st);
    });
  }
  if (dtype == DT_F32) {
    const SimtShape sh{static_cast<int>(H),       static_cast<int>(sq),
                       static_cast<int>(sk),      static_cast<int>(n_kb),
                       static_cast<int>(block_q), static_cast<int>(block_k),
                       static_cast<int>(causal),  scale};
    return with_head_dim(d, [&](auto D) {
      return static_cast<int>(launch_simt<D>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(out), static_cast<float*>(lse), ri,
          rc, lp, sh, B, sq_, sk_, sv_, st));
    });
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
