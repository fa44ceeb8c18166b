// The tile tables K9's kernels walk (blocksparse_attention.cu,
// blocksparse_attention_bwd.cu), built on the card in two launches from the
// blockmask by the forward's C entry, once a call; the backward reads the
// forward's. JAX builds them with an argsort in XLA (flash_attention.py
// _bs_fwd :1197-1202); the plain version is ops/flash_attention.py
// _bs_tables, which these kernels equal bit for bit.
//
// 1. tables_lists_kernel, one warp a query block (a row of the mask) and
//    one a key block (a column): the causal pre-filter of _bs_active
//    (:1175; a key block whose first key lies past the query block's last
//    row is dropped), then the active entries compacted in order by
//    ballots, the inactive ones after them (so the row is the stable
//    argsort of "inactive"), the count, and the work of each of the
//    block's CTAs: a forward query tile of `rows` rows visits the 64-key
//    tiles of its row's active blocks below its last visible key; a
//    backward key tile of `key_tile` keys the 64-query tiles of its
//    column's active blocks from its first key on (causal) and below sq.
// 2. tables_order_kernel: each CTA's rank in descending work (ties in
//    index order: a stable sort), one thread a CTA over the others' work
//    staged through shared memory; order[rank] = CTA.
//
// Bound: the mask read a few times and the tables written once, a few
// microseconds at any mask a sequence of a million tokens gives; what it
// replaced was some 65 launches of tensor ops (~1 ms of host time a call
// on the H100, probe_k9.py).
#pragma once

#include "common.cuh"

namespace {

constexpr int kTableTile = 64;  // the kernels' 64-row tiles

struct TableArgs {
  const int* mask;         // (n_qb, n_kb) int32, nonzero: the tile is attended
  int n_qb, n_kb, sq, sk, block_q, block_k, rows, key_tile, causal;
  int *row_idx, *row_cnt;  // (n_qb, n_kb), (n_qb,)
  int *col_idx, *col_cnt;  // (n_kb, n_qb), (n_kb,)
  int *fwd_order, *bwd_order;  // (n_qt,), (n_kt,)
  int* work;               // scratch: the forward CTAs' work, then the backward's
  int n_qt, n_kt;          // ceil(sq / rows), ceil(sk / key_tile)
};

__device__ __forceinline__ int tiles64(int n) {
  return n > 0 ? (n + kTableTile - 1) / kTableTile : 0;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(256) tables_lists_kernel(const TableArgs t) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * 8 + (threadIdx.x >> 5);
  const bool is_row = w < t.n_qb;
  if (w >= t.n_qb + t.n_kb) return;
  const int i = is_row ? w : w - t.n_qb;   // the block
  const int n = is_row ? t.n_kb : t.n_qb;  // its entries
  int* list = (is_row ? t.row_idx : t.col_idx) + static_cast<long long>(i) * n;
  // entry j of block i: the mask's (i, j) for a row, (j, i) for a column
  auto active = [&](int j) {
    const int qb = is_row ? i : j, kb = is_row ? j : i;
    return t.mask[static_cast<long long>(qb) * t.n_kb + kb] != 0 &&
           (!t.causal || static_cast<long long>(kb) * t.block_k <
                             static_cast<long long>(qb + 1) * t.block_q);
  };
  int cnt = 0;
  for (int pass = 0; pass < 2; ++pass) {  // the active entries, then the rest
    int pos = pass ? cnt : 0;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const bool take = j < n && active(j) == (pass == 0);
      const unsigned m = __ballot_sync(0xffffffffu, take);
      if (take) list[pos + __popc(m & ((1u << lane) - 1u))] = j;
      pos += __popc(m);
    }
    if (pass == 0) cnt = pos;
  }
  if (lane == 0) (is_row ? t.row_cnt : t.col_cnt)[i] = cnt;
  __syncwarp();  // the list, written by every lane, is read by every lane
  if (is_row) {
    for (int q0 = i * t.block_q; q0 < min((i + 1) * t.block_q, t.sq); q0 += t.rows) {
      const int end = t.causal ? min(t.sk, min(q0 + t.rows, t.sq)) : t.sk;
      int work = 0;
      for (int e = lane; e < cnt; e += 32) {
        const int lo = list[e] * t.block_k;
        work += tiles64(min(end, lo + t.block_k) - lo);
      }
      work = warp_sum_int(work);
      if (lane == 0) t.work[q0 / t.rows] = work;
    }
  } else {
    for (int k0 = i * t.block_k; k0 < min((i + 1) * t.block_k, t.sk); k0 += t.key_tile) {
      const int first = t.causal ? k0 : 0;
      int work = 0;
      for (int e = lane; e < cnt; e += 32) {
        const int lo = list[e] * t.block_q;
        work += tiles64(min(lo + t.block_q, t.sq) - max(lo, first));
      }
      work = warp_sum_int(work);
      if (lane == 0) t.work[t.n_qt + k0 / t.key_tile] = work;
    }
  }
}

// blockIdx.y = 0: the forward's CTAs, 1: the backward's
__global__ void __launch_bounds__(256) tables_order_kernel(const TableArgs t) {
  __shared__ int chunk[256];
  const bool fwd = blockIdx.y == 0;
  const int n = fwd ? t.n_qt : t.n_kt;
  const int* work = t.work + (fwd ? 0 : t.n_qt);
  const int i = blockIdx.x * 256 + threadIdx.x;
  const int mine = i < n ? work[i] : 0;
  int rank = 0;
  for (int j0 = 0; j0 < n; j0 += 256) {
    __syncthreads();
    chunk[threadIdx.x] = j0 + threadIdx.x < n ? work[j0 + threadIdx.x] : -1;
    __syncthreads();
    for (int j = 0; j < 256 && j0 + j < n; ++j)
      rank += chunk[j] > mine || (chunk[j] == mine && j0 + j < i);
  }
  if (i < n) (fwd ? t.fwd_order : t.bwd_order)[rank] = i;
}

inline cudaError_t build_tables(const TableArgs& t, cudaStream_t st) {
  const unsigned warps = static_cast<unsigned>(t.n_qb + t.n_kb);
  tables_lists_kernel<<<(warps + 7) / 8, 256, 0, st>>>(t);
  const int n = t.n_qt > t.n_kt ? t.n_qt : t.n_kt;
  tables_order_kernel<<<dim3(static_cast<unsigned>((n + 255) / 256), 2), 256, 0, st>>>(t);
  return cudaGetLastError();
}

}  // namespace
