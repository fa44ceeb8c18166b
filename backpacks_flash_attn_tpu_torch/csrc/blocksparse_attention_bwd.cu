// K9: block-sparse FlashAttention, backward (dq, dk, dv), over only the
// (block_q, block_k) tiles a blockmask marks. The forward is
// blocksparse_attention.cu.
//
// Replaces the TPU kernels of backpacks_flash_attn_tpu/ops/flash_attention.py
// _bs_bwd_rule (:1362): both of its Pallas bodies, _bs_bwd_dq_kernel
// (:1242) and _bs_bwd_dkv_kernel (:1284), which each recompute S and P (7
// products a pair). Here the pass is K5's single one (5 products a pair):
// one C entry, counted once a backward. The caller has scaled q (JAX
// :1439) and passes ops/flash_attention.py _bs_tables, built once a call
// on the card and saved by the forward: each query block's active key
// blocks (the f32 route's dq), each key block's active query blocks (the
// columns), both in order with their counts, and the launch order of the
// key tiles. Pairs are valid as in the forward (an active tile, key <=
// query if causal); no key lengths (the ragged op is forward only, as in
// JAX). sq and sk are independent. Any number of blocks a row or column:
// the kernels read their lists from device memory.
//
// bf16 runs K5's kernels (flash_attention_bwd.cuh) over SparseQueries,
// this file's walk of the query tiles:
// 1. prep: delta = rowsum(dO * O) and the LSE in log2 units into tables
//    padded to 64-query tiles, the f32 dq workspace zeroed (no eager
//    PyTorch around the kernels);
// 2. main: one CTA a key tile (64 keys, or 128 where block_k allows and
//    the sequence is at most 1024, K5's rule), K and V kept, Q / dO / LSE
//    / delta streamed through the 2-stage cp.async ring in the order of
//    the key block's column, each 256-row query block split into 64-row
//    tiles, starting at the tile's own first key when causal (a query
//    tile wholly below it sees none of its keys). S^T and dP^T once a
//    tile, dV and dK in registers, dQ by 16-byte f32 atomics. The key
//    tiles with the most query tiles launch first (in the band mask, key
//    block 0, which every query block sees).
// 3. convert: dq = workspace * scale in bf16.
// dk and dv are deterministic; dq is not: the order in which the key
// tiles' f32 partials land varies from run to run, so dq may differ in its
// last bits between two runs on the same inputs (each holds the 2x rule).
// f32 operands take the SIMT kernels below (delta from the shared
// delta_kernel; dq over the query block's row, dk/dv over the key block's
// column; every product in f32, no atomics).
//
// Bound on the H100 at chip_smoke's long-context case (b 4, s 4096, h 12,
// d 64, the band mask: 1.95e8 valid pairs): the five products, 10 x pairs
// x 64 FLOP = 1.25e11, 0.1263 ms at 989 TFLOP/s, against 0.061 ms of
// bytes (q, k, v, out, dO read and dq, dk, dv written once, the LSE and
// delta). At s 2048 / 8192 (16384 tokens): 1.64e8 / 2.11e8 pairs, 0.1059 /
// 0.1365 ms.
#include "flash_attention_bwd.cuh"

namespace {

// K9's walk: the key block's active query blocks (col_idx, ascending),
// each split into tpq = block_q / BQ tiles. Causal: the blocks that end at
// or before the key tile's first key are a prefix of the list and are
// skipped, and the first block kept starts at that key; the last block is
// cut at Sq.
struct SparseQueries {
  struct Params {
    const int *col_idx, *col_cnt, *order;  // (n_kb, n_qb), (n_kb,), (key tiles,)
    int n_qb, block_q, block_k;
  };
  const int* list;
  int k0, e0, sub0, n, tpq, block_q;
  __device__ __forceinline__ SparseQueries(const Params& p, const BwdArgs& a, int BK)
      : k0(p.order[blockIdx.y] * BK), e0(0), sub0(0), n(0), tpq(p.block_q / BQ),
        block_q(p.block_q) {
    const int kb = k0 / p.block_k;
    list = p.col_idx + static_cast<long long>(kb) * p.n_qb;
    const int cnt = p.col_cnt[kb];
    const int first = a.causal ? k0 : 0;  // the first query row any key of the tile sees
    int lo = 0, hi = cnt;                 // the entries whose block ends at or before it
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((list[mid] + 1) * block_q <= first)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo == cnt) return;
    e0 = lo;
    sub0 = max(0, first - list[e0] * block_q) / BQ;
    const int last = min(tpq, (a.Sq - list[cnt - 1] * block_q + BQ - 1) / BQ);
    n = max(0, (cnt - e0) * tpq - sub0 - (tpq - last));
  }
  __device__ __forceinline__ int tiles() const { return n; }
  __device__ __forceinline__ int q0(int t) const {
    const int u = sub0 + t;
    return list[e0 + u / tpq] * block_q + (u % tpq) * BQ;
  }
};

// ------------------------------------------------------------- f32 (SIMT)

constexpr int ST = 32, SLD = D + 1, kSimtThreads = 256;

struct SimtShape {
  int H, Sq, Sk, n_qb, n_kb, block_q, block_k, causal;
  float scale;
};

// 32 rows from r0 of a row-strided f32 matrix into shared memory; rows at
// or past S are zero
__device__ __forceinline__ void load_rows(float (*dst)[SLD], const float* base, long long st,
                                          int r0, int S) {
  for (int idx = threadIdx.x; idx < ST * D; idx += kSimtThreads) {
    const int rr = idx / D, dd = idx % D;
    dst[rr][dd] = r0 + rr < S ? base[(r0 + rr) * st + dd] : 0.f;
  }
}

__device__ __forceinline__ float dot64(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 16
  for (int dd = 0; dd < D; ++dd) acc += a[dd] * b[dd];
  return acc;
}

// one block per (32-query tile, head, batch row) over its query block's
// active key blocks; thread (r, c) = query q0 + r, keys c + 8 i of each
// tile, gradient columns c + 8 j
__global__ void __launch_bounds__(kSimtThreads)
dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, const int* __restrict__ row_idx,
               const int* __restrict__ row_cnt, SimtShape sh, Strides sq, Strides sk,
               Strides sv, Strides sd) {
  __shared__ float Qs[ST][SLD], Ds[ST][SLD], Ks[ST][SLD], Vs[ST][SLD];
  __shared__ float DSs[ST][ST + 1];
  const int q0 = blockIdx.x * ST, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7, qry = q0 + r;
  const long long bh = static_cast<long long>(b) * sh.H + h;
  const int qb = q0 / sh.block_q;
  const int* list = row_idx + static_cast<long long>(qb) * sh.n_kb;
  const int n_act = row_cnt[qb];
  load_rows(Qs, q + b * sq.sb + h * sq.sh, sq.st, q0, sh.Sq);
  load_rows(Ds, dout + b * sd.sb + h * sd.sh, sd.st, q0, sh.Sq);
  const float row_lse = qry < sh.Sq ? lse[bh * sh.Sq + qry] : 0.f;
  const float row_delta = qry < sh.Sq ? delta[bh * sh.Sq + qry] : 0.f;
  float dq_acc[D / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq_acc[j] = 0.f;

  const float* kb = k + b * sk.sb + h * sk.sh;
  const float* vb = v + b * sv.sb + h * sv.sh;
  const int kv_end = sh.causal ? min(sh.Sk, q0 + ST) : sh.Sk;
  for (int i = 0; i < n_act; ++i) {
    const int j_lo = list[i] * sh.block_k, j_hi = min(j_lo + sh.block_k, kv_end);
    for (int j0 = j_lo; j0 < j_hi; j0 += ST) {
      __syncthreads();
      load_rows(Ks, kb, sk.st, j0, sh.Sk);
      load_rows(Vs, vb, sv.st, j0, sh.Sk);
      __syncthreads();
#pragma unroll
      for (int t = 0; t < ST / 8; ++t) {
        const int kl = c + 8 * t, key = j0 + kl;
        const bool valid = key < sh.Sk && qry < sh.Sq && (!sh.causal || key <= qry);
        const float p = valid ? expf(dot64(Qs[r], Ks[kl]) * sh.scale - row_lse) : 0.f;
        DSs[r][kl] = p * (dot64(Ds[r], Vs[kl]) - row_delta);
      }
      __syncwarp();
      for (int kl = 0; kl < ST; ++kl) {
        const float ds = DSs[r][kl];
#pragma unroll
        for (int j = 0; j < D / 8; ++j) dq_acc[j] += ds * Ks[kl][c + 8 * j];
      }
    }
  }
  if (qry >= sh.Sq) return;
  float* drow = dq + ((static_cast<long long>(b) * sh.Sq + qry) * sh.H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) drow[c + 8 * j] = dq_acc[j] * sh.scale;
}

// one block per (32-key tile, head, batch row) over its key block's active
// query blocks; thread (r, c) = key k0 + r, queries c + 8 i of each tile,
// gradient columns c + 8 j
__global__ void __launch_bounds__(kSimtThreads)
dkdv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, const int* __restrict__ col_idx,
                 const int* __restrict__ col_cnt, SimtShape sh, Strides sq, Strides sk,
                 Strides sv, Strides sd) {
  __shared__ float Ks[ST][SLD], Vs[ST][SLD], Qs[ST][SLD], Ds[ST][SLD];
  __shared__ float Ps[ST][ST + 1], DSs[ST][ST + 1];
  __shared__ float Ls[ST], Dl[ST];
  const int k0 = blockIdx.x * ST, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7, key = k0 + r;
  const long long bh = static_cast<long long>(b) * sh.H + h;
  const int kb_ = k0 / sh.block_k;
  const int* list = col_idx + static_cast<long long>(kb_) * sh.n_qb;
  const int n_act = col_cnt[kb_];
  load_rows(Ks, k + b * sk.sb + h * sk.sh, sk.st, k0, sh.Sk);
  load_rows(Vs, v + b * sv.sb + h * sv.sh, sv.st, k0, sh.Sk);
  float dk_acc[D / 8], dv_acc[D / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  const float* qb = q + b * sq.sb + h * sq.sh;
  const float* db = dout + b * sd.sb + h * sd.sh;
  for (int i = 0; i < n_act; ++i) {
    const int q_lo = list[i] * sh.block_q, q_hi = min(q_lo + sh.block_q, sh.Sq);
    // a query tile wholly below this key tile is causally masked
    for (int q0 = sh.causal ? max(q_lo, k0) : q_lo; q0 < q_hi; q0 += ST) {
      __syncthreads();  // the previous tiles are consumed (and K, V staged)
      load_rows(Qs, qb, sq.st, q0, sh.Sq);
      load_rows(Ds, db, sd.st, q0, sh.Sq);
      for (int t = threadIdx.x; t < ST; t += kSimtThreads) {
        const bool in = q0 + t < sh.Sq;
        Ls[t] = in ? lse[bh * sh.Sq + q0 + t] : 0.f;
        Dl[t] = in ? delta[bh * sh.Sq + q0 + t] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int t = 0; t < ST / 8; ++t) {
        const int ql = c + 8 * t, qry = q0 + ql;
        const bool valid = key < sh.Sk && qry < sh.Sq && (!sh.causal || key <= qry);
        const float p = valid ? expf(dot64(Ks[r], Qs[ql]) * sh.scale - Ls[ql]) : 0.f;
        Ps[r][ql] = p;
        DSs[r][ql] = p * (dot64(Vs[r], Ds[ql]) - Dl[ql]);
      }
      __syncwarp();  // the row's eight threads share one warp
      for (int ql = 0; ql < ST; ++ql) {
        const float p = Ps[r][ql], ds = DSs[r][ql];
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          dv_acc[j] += p * Ds[ql][c + 8 * j];
          dk_acc[j] += ds * Qs[ql][c + 8 * j];
        }
      }
    }
  }
  if (key >= sh.Sk) return;
  const long long o = ((static_cast<long long>(b) * sh.Sk + key) * sh.H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk[o + c + 8 * j] = dk_acc[j] * sh.scale;
    dv[o + c + 8 * j] = dv_acc[j];
  }
}

}  // namespace

// q, out, dout (B, sq, H, 64), k, v (B, sk, H, 64), bf16 or f32 (dtype)
// with the given (batch, row, head) strides, bf16 rows 16-byte aligned; lse
// (B, H, sq) f32; row_idx, row_cnt, col_idx, col_cnt and bwd_order: the
// tables blocksparse_fwd_launch built for the forward. ws: f32
// workspace, bf16: the dq accumulator (B * sq * H * 64) then the LSE and
// delta tables (B * H * sq_pad each, sq_pad = sq rounded up to 64); f32:
// delta (B * H * sq). dq (B, sq, H, 64), dk, dv (B, sk, H, 64): contiguous
// outputs of the operands' dtype. key_tile (bf16): 64, or 128 where
// block_k allows.
extern "C" int blocksparse_bwd_launch(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, void* ws, void* dq, void* dk, void* dv, const void* row_idx,
    const void* row_cnt, const void* col_idx, const void* col_cnt, const void* bwd_order,
    long long B, long long H, long long sq, long long sk, long long n_qb, long long n_kb,
    long long block_q, long long block_k, long long key_tile,
    long long q_sb, long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh, long long o_sb,
    long long o_st, long long o_sh, long long d_sb, long long d_st, long long d_sh,
    float scale, long long causal, long long dtype, void* stream) {
  if (block_q % BQ || block_k % key_tile || block_q <= 0 || block_k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B * H * sq * sk == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sq_{q_sb, q_st, q_sh}, sk_{k_sb, k_st, k_sh}, sv_{v_sb, v_st, v_sh},
      so{o_sb, o_st, o_sh}, sd{d_sb, d_st, d_sh};
  const auto* lp = static_cast<const float*>(lse);
  auto* wp = static_cast<float*>(ws);
  const auto* ci = static_cast<const int*>(col_idx);
  const auto* cc = static_cast<const int*>(col_cnt);
  if (dtype == DT_BF16) {
    BwdArgs a{};
    a.q = static_cast<const bf16*>(q);
    a.k = static_cast<const bf16*>(k);
    a.v = static_cast<const bf16*>(v);
    a.dout = static_cast<const bf16*>(dout);
    a.dk = static_cast<bf16*>(dk);
    a.dv = static_cast<bf16*>(dv);
    a.H = static_cast<int>(H);
    a.Sq = static_cast<int>(sq);
    a.Sk = static_cast<int>(sk);
    a.causal = static_cast<int>(causal);
    a.sq = sq_;
    a.sk = sk_;
    a.sv = sv_;
    a.sd = sd;
    a.scale = scale;
    const SparseQueries::Params wq{ci, cc, static_cast<const int*>(bwd_order),
                                   static_cast<int>(n_qb), static_cast<int>(block_q),
                                   static_cast<int>(block_k)};
    return static_cast<int>(bwd_bf16<SparseQueries, false>(
        a, wq, static_cast<const bf16*>(out), so, lp, wp, static_cast<bf16*>(dq), B, key_tile,
        st));
  }
  if (dtype != DT_F32) return static_cast<int>(cudaErrorInvalidValue);
  const SimtShape sh{static_cast<int>(H),       static_cast<int>(sq),
                     static_cast<int>(sk),      static_cast<int>(n_qb),
                     static_cast<int>(n_kb),    static_cast<int>(block_q),
                     static_cast<int>(block_k), static_cast<int>(causal),
                     scale};
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* dp = static_cast<const float*>(dout);
  const cudaError_t err = launch_delta(out, dp, wp, B, H, sq, so, sd, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kgrid(static_cast<unsigned>((sk + ST - 1) / ST), static_cast<unsigned>(H),
                   static_cast<unsigned>(B));
  dkdv_simt_kernel<<<kgrid, kSimtThreads, 0, st>>>(qp, kp, vp, dp, lp, wp,
                                                   static_cast<float*>(dk),
                                                   static_cast<float*>(dv), ci, cc, sh, sq_, sk_,
                                                   sv_, sd);
  const dim3 qgrid(static_cast<unsigned>((sq + ST - 1) / ST), static_cast<unsigned>(H),
                   static_cast<unsigned>(B));
  dq_simt_kernel<<<qgrid, kSimtThreads, 0, st>>>(qp, kp, vp, dp, lp, wp, static_cast<float*>(dq),
                                                 static_cast<const int*>(row_idx),
                                                 static_cast<const int*>(row_cnt), sh, sq_, sk_,
                                                 sv_, sd);
  return static_cast<int>(cudaGetLastError());
}
