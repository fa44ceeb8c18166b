// The tensor-core FlashAttention forward of K3 (flash_attention.cu) and K9
// (blocksparse_attention.cu): one kernel body, two walks over the key
// tiles.
//
//   DenseKeys   K3: the key tiles 0, 64, 128, ... below the last key the
//               block's rows may see; query tiles with the most keys first.
//   (K9's)      the query block's list of active key blocks, each split
//               into 64-key tiles (blocksparse_attention.cu SparseKeys).
//
// A walk gives the kernel its query tile (q0, from blockIdx.y), the number
// of key tiles it visits (from the block's key limit kv_end) and the first
// key of tile t. The cp.async ring prefetches tile t + 1 of the walk while
// tile t multiplies, whatever key it starts at; the body neither knows nor
// tests which walk it runs. The design notes (tiles, MT, the masks) are in
// flash_attention.cu.
#pragma once

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int D = 64;

constexpr int BK = 64;       // keys a K/V tile
constexpr int LD = D + 8;    // 144-byte smem rows: 16-byte aligned, ldmatrix conflict-free
constexpr int kStages = 2;   // K/V tiles in the cp.async ring
constexpr float kLn2 = 0.6931471805599453f;

struct MmaArgs {
  const bf16 *q, *k, *v;
  bf16* out;
  float* lse;
  const int *seq_lengths, *q_offsets;  // NULL: sk and 0 for every sequence
  int H, sq, sk, causal;
  Strides sq_, sk_, sv_;
  float scale_log2;  // softmax scale * log2(e), > 0
  DropoutParams drop;
};

// K3's walk: every key tile below kv_end, in order; the query tiles with
// the most keys first (reverse blockIdx.y), so the causal tail does not
// leave SMs idle
struct DenseKeys {
  struct Params {};
  int q0;
  __device__ __forceinline__ DenseKeys(const Params&, const MmaArgs&, int BQ)
      : q0((gridDim.y - 1 - blockIdx.y) * BQ) {}
  __device__ __forceinline__ int tiles(int kv_end) const {
    return kv_end > 0 ? (kv_end + BK - 1) / BK : 0;
  }
  __device__ __forceinline__ int key0(int t) const { return t * BK; }
};

// max of the NF pairs (nf, e) a lane holds for one row (accumulator half
// `half`), as a tree
template <int NF>
__device__ __forceinline__ float row_max(const float (&s)[NF][4], int half) {
  float m[NF];
#pragma unroll
  for (int nf = 0; nf < NF; ++nf) m[nf] = fmaxf(s[nf][2 * half], s[nf][2 * half + 1]);
#pragma unroll
  for (int w = NF / 2; w > 0; w >>= 1)
#pragma unroll
    for (int i = 0; i < w; ++i) m[i] = fmaxf(m[i], m[i + w]);
  return m[0];
}

// The per-warp state of the online softmax: Q's A fragments, and per row
// group and accumulator half (rows g, g + 8) the running max in log2 units
// (-inf: no valid key yet), the pre-dropout sum and the output rows.
template <int MT>
struct WarpRows {
  uint32_t qa[MT][D / 16][4];
  float m[MT][2], l[MT][2];
  float o[MT][D / 8][4];
};

// Q's A fragments: at MT = 1 (128 registers a thread) read from shared
// memory for every tile (ldmatrix), at MT = 2 held in registers
template <int MT>
constexpr bool kQInSmem = MT == 1;

// One BK-key tile (K and V in shared memory, [key][d]) into the warp's
// rows qw, ..., qw + 16 * MT - 1 (rows qs, ... of the Q tile in shared
// memory)
template <int MT, bool DROP>
__device__ __forceinline__ void attend_tile(WarpRows<MT>& w, const bf16* Qs, int qs,
                                            const bf16* Ks, const bf16* Vs, const MmaArgs& a,
                                            int j0, int qw, int q_off, int kv_len, bool edge,
                                            uint32_t bh) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  // S = Q K^T: one ldmatrix.x4 gives the B fragments of two 8-key blocks
  float s[MT][BK / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) zero(s[mt]);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t qf[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (kQInSmem<MT>)
        ldmatrix_x4(qf[mt], Qs + (qs + 16 * mt + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
      else
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[mt][e] = w.qa[mt][ks][e];
    }
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t bk[4];
      ldmatrix_x4(bk, Ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + ks * 16 +
                          ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_16816(s[mt][2 * np], qf[mt], bk);
        mma_16816(s[mt][2 * np + 1], qf[mt], bk + 2);
      }
    }
  }
  // the mask (-inf) only on tiles that straddle the length or the
  // diagonal (a warp-uniform branch); the running max of the raw scores
  // (scale > 0); o and l rescaled once
  if (edge) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = qw + 16 * mt + g + 8 * half;
        const int lim = a.causal ? min(kv_len, q_off + row + 1) : kv_len;  // keys below are valid
#pragma unroll
        for (int nf = 0; nf < BK / 8; ++nf)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (j0 + nf * 8 + 2 * tq + e >= lim) s[mt][nf][2 * half + e] = -INFINITY;
      }
  }
  float mu[MT][2];  // the max the exponents subtract (0 while no key is valid)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float m_new =
          fmaxf(w.m[mt][half], group_max(row_max(s[mt], half), 4) * a.scale_log2);
      mu[mt][half] = m_new == -INFINITY ? 0.f : m_new;
      const float corr = ex2(w.m[mt][half] - mu[mt][half]);
      w.m[mt][half] = m_new;
      w.l[mt][half] *= corr;
#pragma unroll
      for (int nf = 0; nf < D / 8; ++nf) {
        w.o[mt][nf][2 * half] *= corr;
        w.o[mt][nf][2 * half + 1] *= corr;
      }
    }
  // P in 16-key chunks, each turned into one A fragment and multiplied
  // into O as it is made. Dropout zeroes the dropped probabilities after
  // the sum; the 1 / (1 - p) of the kept ones is applied to O at the end.
  float rs[MT][2][2] = {};  // two partial sums a row
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int nf = 2 * kk + n2;
          float p[2], kept[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            p[e] = ex2(fmaf(s[mt][nf][2 * half + e], a.scale_log2, -mu[mt][half]));
            kept[e] = !DROP || dropout_keep(
                                   a.drop, bh,
                                   static_cast<uint32_t>(q_off + qw + 16 * mt + g + 8 * half),
                                   static_cast<uint32_t>(j0 + nf * 8 + 2 * tq + e))
                          ? p[e]
                          : 0.f;
          }
          rs[mt][half][n2] += p[0] + p[1];
          pa[mt][n2 * 2 + half] = pack_bf16x2(kept[0], kept[1]);  // to_a's slot for (nf, half)
        }
#pragma unroll
    for (int nj = 0; nj < D / 16; ++nj) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, Vs + (kk * 16 + (lane & 15)) * LD + nj * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_16816(w.o[mt][2 * nj], pa[mt], bv);
        mma_16816(w.o[mt][2 * nj + 1], pa[mt], bv + 2);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    w.l[mt][0] += group_sum(rs[mt][0][0] + rs[mt][0][1], 4);
    w.l[mt][1] += group_sum(rs[mt][1][0] + rs[mt][1][1], 4);
  }
}

// One block per (query tile of 16 * MT * WARPS rows, head, batch row).
// A warp owns MT groups of 16 query rows, so every K and V fragment it
// reads from shared memory feeds MT products; 16 warps an SM at MT = 1
// (at most 128 registers a thread), 8 at MT = 2 (at most 255). DROP is
// whether dropout is on, so neither form branches inside the tile. Walk
// picks the query tile and the key tiles (DenseKeys above, K9's
// SparseKeys).
template <int WARPS, int MT, bool DROP, class Walk>
__global__ void __launch_bounds__(32 * WARPS, 16 / (WARPS * MT))
    flash_fwd_mma_kernel(const MmaArgs a, const typename Walk::Params wp) {
  constexpr int RW = 16 * MT, BQ = RW * WARPS, kThreads = 32 * WARPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* ring = Qs + BQ * LD;                     // kStages x (K, V), BK x LD each

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const Walk walk(wp, a, BQ);
  const int q0 = walk.q0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
  const int qw = q0 + RW * warp;  // the warp's first query row
  const int kv_len = a.seq_lengths ? min(a.seq_lengths[b], a.sk) : a.sk;
  const int q_off = a.q_offsets ? a.q_offsets[b] : 0;
  // keys at or past these bounds are masked for every row of the block,
  // and of the warp (0: the warp's rows all lie past sq)
  const int kv_end = a.causal ? min(kv_len, q_off + min(q0 + BQ, a.sq)) : kv_len;
  const int warp_end =
      qw >= a.sq ? 0 : a.causal ? min(kv_len, q_off + min(qw + RW, a.sq)) : kv_len;
  const int n_tiles = walk.tiles(kv_end);

  const bf16* kb = a.k + b * a.sk_.sb + h * a.sk_.sh;
  const bf16* vb = a.v + b * a.sv_.sb + h * a.sv_.sh;
  auto load_kv = [&](int t) {
    bf16* Ks = ring + (t % kStages) * 2 * BK * LD;
    const int j0 = walk.key0(t);
    load_rows_async<BK, kThreads>(Ks, kb, a.sk_.st, j0, kv_len);
    load_rows_async<BK, kThreads>(Ks + BK * LD, vb, a.sv_.st, j0, kv_len);
  };
  // Q goes with the first K/V tile's commit group
  if (n_tiles > 0)
    load_rows_async<BQ, kThreads>(Qs, a.q + b * a.sq_.sb + h * a.sq_.sh, a.sq_.st, q0, a.sq);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }

  WarpRows<MT> w;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    w.m[mt][0] = w.m[mt][1] = -INFINITY;
    w.l[mt][0] = w.l[mt][1] = 0.f;
    zero(w.o[mt]);
  }
  const uint32_t bh = static_cast<uint32_t>(b * a.H + h);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t (and Q) have landed
    __syncthreads();               // ... for every thread; tile t - 1 is consumed
    if (t + kStages - 1 < n_tiles) load_kv(t + kStages - 1);
    cp_async_commit();
    const int j0 = walk.key0(t);
    if (!kQInSmem<MT> && t == 0 && warp_end > 0)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) a_frags(w.qa[mt], Qs, LD, RW * warp + 16 * mt, g, tq);
    if (j0 >= warp_end) continue;  // warp-uniform: no key of the tile for these rows
    const bf16* Ks = ring + (t % kStages) * 2 * BK * LD;
    const bool edge = j0 + BK > kv_len || (a.causal && j0 + BK - 1 > q_off + qw);
    attend_tile<MT, DROP>(w, Qs, RW * warp, Ks, Ks + BK * LD, a, j0, qw, q_off, kv_len, edge,
                          bh);
  }
  cp_async_wait<0>();

  const float keep_scale = DROP ? a.drop.inv_keep : 1.f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = qw + 16 * mt + g + 8 * half;
      if (row >= a.sq) continue;
      const float lv = w.l[mt][half];
      const float inv = lv == 0.f ? 1.f : keep_scale / lv;
      bf16* orow = a.out + ((static_cast<long long>(b) * a.sq + row) * a.H + h) * D;
#pragma unroll
      for (int nf = 0; nf < D / 8; ++nf)
        *reinterpret_cast<__nv_bfloat162*>(orow + nf * 8 + 2 * tq) =
            __floats2bfloat162_rn(w.o[mt][nf][2 * half] * inv, w.o[mt][nf][2 * half + 1] * inv);
      if (tq == 0)
        a.lse[(static_cast<long long>(b) * a.H + h) * a.sq + row] =
            lv == 0.f ? FLASH_NEG_INF : (w.m[mt][half] + log2f(lv)) * kLn2;
    }
}

template <int WARPS, int MT, bool DROP, class Walk>
int launch_form(const MmaArgs& a, const typename Walk::Params& wp, long long B,
                cudaStream_t stream) {
  constexpr int BQ = 16 * MT * WARPS;
  const size_t smem = sizeof(bf16) * (BQ + 2 * kStages * BK) * LD;
  const cudaError_t err = allow_smem<flash_fwd_mma_kernel<WARPS, MT, DROP, Walk>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * a.H), static_cast<unsigned>((a.sq + BQ - 1) / BQ));
  flash_fwd_mma_kernel<WARPS, MT, DROP, Walk><<<grid, 32 * WARPS, smem, stream>>>(a, wp);
  return static_cast<int>(cudaGetLastError());
}

// The query rows a block takes: the serve prefill's 32 queries a 32-row
// tile, so no warp idles; 64-row tiles of 4 warps up to sq 1024 (at the
// training and forward shapes more, shorter blocks beat longer ones);
// longer sequences (bound by the products) 128-row tiles of 4 warps of 32
// rows, which halve the shared-memory reads per product. (K9's wrapper
// mirrors this as ops.flash_attention._k9_rows, to size its tables;
// tests/test_torch_k9_schedule.py reads this line and holds the two equal.)
inline int k3_rows(long long sq) { return sq <= 32 ? 32 : sq <= 1024 ? 64 : 128; }

// Launch the body over `rows`-row query tiles (32, 64 or 128); DROPS:
// whether dropout may be on (K9 has none, so its instances are not built).
template <class Walk, bool DROPS>
int launch_rows(const MmaArgs& a, const typename Walk::Params& wp, int rows, long long B,
                cudaStream_t st) {
  const bool drop = DROPS && a.drop.on;
  switch (rows) {
    case 32:
      return drop ? launch_form<2, 1, DROPS, Walk>(a, wp, B, st)
                  : launch_form<2, 1, false, Walk>(a, wp, B, st);
    case 64:
      return drop ? launch_form<4, 1, DROPS, Walk>(a, wp, B, st)
                  : launch_form<4, 1, false, Walk>(a, wp, B, st);
    case 128:
      return drop ? launch_form<4, 2, DROPS, Walk>(a, wp, B, st)
                  : launch_form<4, 2, false, Walk>(a, wp, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
