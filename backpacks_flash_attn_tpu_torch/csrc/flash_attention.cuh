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
//
// The head dim D (64, 80, 96 or 128; the wrapper pads any other d <= 128
// with zero columns to the next) is a template argument: K, V and Q rows of
// D + 8 bf16 in shared memory (144, 176, 208 and 272 bytes: 16-byte aligned,
// and the 8 rows of an ldmatrix land on 8 distinct 4-bank groups), D / 16
// k-steps for S = Q K^T and D / 8 output fragments a row group.
#pragma once

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;       // keys a K/V tile
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
  // the ring forms: the absolute position of key column 0 (NULL: 0 for
  // every sequence) and the global index of batch row 0. Causality sees
  // q_offsets[b] - k_offsets[b], the dropout hash the absolute positions
  // and the stream (bh_offset + b) * hash_heads + head_offset + h.
  const int* k_offsets = nullptr;
  int bh_offset = 0;
  // the additive score bias (read by the BIAS instances only)
  ScoreBias bias = {};
  // a head shard (tensor parallelism): the call's H heads are heads
  // [head_offset, head_offset + H) of hash_heads, and the dropout stream is
  // (bh_offset + b) * hash_heads + head_offset + h, the unsharded call's.
  // K3 sets both (hash_heads = H, head_offset = 0 without a shard); K9 has
  // no dropout and leaves them
  int hash_heads = 0;
  int head_offset = 0;
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
template <int D, int MT>
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
// memory). BIAS: bias_bh is the bias of the block's (b, h), added to the
// scores in log2 units (times log2 e) before the mask; dropout is then a
// warp-uniform branch on a.drop.on (the bias instances are built with
// DROP only, which halves their number).
template <int D, int MT, bool DROP, bool BIAS>
__device__ __forceinline__ void attend_tile(WarpRows<D, MT>& w, const bf16* Qs, int qs,
                                            const bf16* Ks, const bf16* Vs, const MmaArgs& a,
                                            int j0, int qw, int q_off, int kv_len, bool edge,
                                            uint32_t bh, int q_abs, int k_abs,
                                            const float* bias_bh) {
  constexpr int LD = D + 8;
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
  // With a bias the scores turn into log2 units here (s * scale log2 e +
  // bias * log2 e, the bias read in the accumulator layout with the rows
  // clamped below sq and the keys below sk: rows past sq are never
  // stored, keys past sk are masked below), so the max, the exponents and
  // the LSE take them as they are (sl2 = 1); without one they stay raw
  // and sl2 scales them.
  if constexpr (BIAS) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* brow =
            bias_bh + min(qw + 16 * mt + g + 8 * half, a.sq - 1) * a.bias.sq;
#pragma unroll
        for (int nf = 0; nf < BK / 8; ++nf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float bv = __ldg(brow + min(j0 + nf * 8 + 2 * tq + e, a.sk - 1));
            s[mt][nf][2 * half + e] = fmaf(s[mt][nf][2 * half + e], a.scale_log2, bv * kLog2e);
          }
      }
  }
  const float sl2 = BIAS ? 1.f : a.scale_log2;
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
          fmaxf(w.m[mt][half], group_max(row_max(s[mt], half), 4) * sl2);
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
            p[e] = ex2(fmaf(s[mt][nf][2 * half + e], sl2, -mu[mt][half]));
            kept[e] = !DROP || (BIAS && !a.drop.on) || dropout_keep(
                                   a.drop, bh,
                                   static_cast<uint32_t>(q_abs + qw + 16 * mt + g + 8 * half),
                                   static_cast<uint32_t>(k_abs + j0 + nf * 8 + 2 * tq + e))
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

// The warps an SM the register budget is cut for: at D = 64 16 (at most
// 128 registers a thread at MT = 1); past it the output fragments grow
// with D (64 f32 a thread at D = 128), so 12 (170 registers) at D 80 and
// 96 and 8 (255) at D 128, which shared memory allows no more of anyway
// (87 KB a 64-row block).
template <int D>
constexpr int kSmWarps = D <= 64 ? 16 : D <= 96 ? 12 : 8;

// One block per (query tile of 16 * MT * WARPS rows, head, batch row).
// A warp owns MT groups of 16 query rows, so every K and V fragment it
// reads from shared memory feeds MT products; 16 warps an SM at MT = 1
// (at most 128 registers a thread), 8 at MT = 2 (at most 255; D = 64
// only). DROP is whether dropout is on, so neither form branches inside
// the tile. Walk picks the query tile and the key tiles (DenseKeys above,
// K9's SparseKeys). BIAS: whether a.bias is added to the scores (K3 only);
// its instances take one block an SM fewer, for the registers of the bias
// reads (the no-bias budget spilled them at D 64, 80 and 96).
template <int D, int WARPS, int MT, bool DROP, class Walk, bool BIAS = false>
__global__ void __launch_bounds__(32 * WARPS, kSmWarps<D> / (WARPS * MT) - (BIAS ? 1 : 0))
    flash_fwd_mma_kernel(const MmaArgs a, const typename Walk::Params wp) {
  static_assert(D % 16 == 0 && D <= 128 && (MT == 1 || D == 64), "a head dim instance");
  constexpr int RW = 16 * MT, BQ = RW * WARPS, kThreads = 32 * WARPS, LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* ring = Qs + BQ * LD;                     // kStages x (K, V), BK x LD each

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const Walk walk(wp, a, BQ);
  const int q0 = walk.q0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
  const int qw = q0 + RW * warp;  // the warp's first query row
  const int kv_len = a.seq_lengths ? min(a.seq_lengths[b], a.sk) : a.sk;
  const int q_abs = a.q_offsets ? a.q_offsets[b] : 0;
  const int k_abs = a.k_offsets ? a.k_offsets[b] : 0;
  const int q_off = q_abs - k_abs;  // causality: key u is visible to row i at u <= q_off + i
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
    load_rows_async<BK, kThreads, D>(Ks, kb, a.sk_.st, j0, kv_len);
    load_rows_async<BK, kThreads, D>(Ks + BK * LD, vb, a.sv_.st, j0, kv_len);
  };
  // Q goes with the first K/V tile's commit group
  if (n_tiles > 0)
    load_rows_async<BQ, kThreads, D>(Qs, a.q + b * a.sq_.sb + h * a.sq_.sh, a.sq_.st, q0,
                                     a.sq);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }

  WarpRows<D, MT> w;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    w.m[mt][0] = w.m[mt][1] = -INFINITY;
    w.l[mt][0] = w.l[mt][1] = 0.f;
    zero(w.o[mt]);
  }
  const uint32_t bh = static_cast<uint32_t>((a.bh_offset + b) * a.hash_heads + a.head_offset + h);
  const float* bias_bh = BIAS ? a.bias.p + b * a.bias.sb + h * a.bias.sh : nullptr;

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
    attend_tile<D, MT, DROP, BIAS>(w, Qs, RW * warp, Ks, Ks + BK * LD, a, j0, qw, q_off, kv_len,
                                   edge, bh, q_abs, k_abs, bias_bh);
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

template <int D, int WARPS, int MT, bool DROP, class Walk, bool BIAS = false>
int launch_form(const MmaArgs& a, const typename Walk::Params& wp, long long B,
                cudaStream_t stream) {
  constexpr int BQ = 16 * MT * WARPS;
  const size_t smem = sizeof(bf16) * (BQ + 2 * kStages * BK) * (D + 8);
  const cudaError_t err = allow_smem<flash_fwd_mma_kernel<D, WARPS, MT, DROP, Walk, BIAS>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * a.H), static_cast<unsigned>((a.sq + BQ - 1) / BQ));
  flash_fwd_mma_kernel<D, WARPS, MT, DROP, Walk, BIAS><<<grid, 32 * WARPS, smem, stream>>>(a, wp);
  return static_cast<int>(cudaGetLastError());
}

// The query rows a block takes: the serve prefill's 32 queries a 32-row
// tile, so no warp idles; 64-row tiles of 4 warps up to sq 1024 (at the
// training and forward shapes more, shorter blocks beat longer ones);
// longer sequences (bound by the products) 128-row tiles of 4 warps of 32
// rows at head dim 64, which halve the shared-memory reads per product
// (past 64 a warp's two row groups' output fragments and scores would not
// fit its 255 registers, so wider heads keep 64-row tiles). (K9's wrapper
// mirrors this as ops.flash_attention._k9_rows, to size its tables;
// tests/test_torch_k9_schedule.py reads this line and holds the two equal.)
inline int k3_rows(long long sq, int d) { return sq <= 32 ? 32 : sq <= 1024 || d > 64 ? 64 : 128; }

// The SIMT loops of K3 (flash_attention.cu) and K9's forward
// (blocksparse_attention.cu): 256 threads a 64-query tile over 32-key
// tiles. Their D-wide tiles (Q and K rows of D + 1 floats, V rows of D) in
// floats, and whether those and P fit the static limit.
constexpr int BQ_SIMT = 64, BKV_SIMT = 32, kSimtThreads = 256;
template <int D>
constexpr int kSimtDynFloats = (BQ_SIMT + BKV_SIMT) * (D + 1) + BKV_SIMT * D;
template <int D>
constexpr bool kSimtStatic =
    4 * (kSimtDynFloats<D> + BQ_SIMT * (BKV_SIMT + 1)) <= kStaticSmemBytes;

// Launch the body at head dim D over `rows`-row query tiles (32, 64 or 128
// at D = 64); DROPS: whether dropout may be on (K9 has none, so its
// instances are not built); BIASES: whether a score bias may be given
// (K3 only). A call with a bias takes 64-row tiles whatever `rows` says,
// and the DROPS instance whether dropout is on or not: its instances are
// built at that one form (4 warps of 16 rows), which keeps their count to
// one a head dim and a warp to one row group's registers.
template <int D, class Walk, bool DROPS, bool BIASES = false>
int launch_rows(const MmaArgs& a, const typename Walk::Params& wp, int rows, long long B,
                cudaStream_t st) {
  const bool drop = DROPS && a.drop.on;
  if constexpr (BIASES)
    if (a.bias.p) return launch_form<D, 4, 1, DROPS, Walk, true>(a, wp, B, st);
  switch (rows) {
    case 32:
      return drop ? launch_form<D, 2, 1, DROPS, Walk>(a, wp, B, st)
                  : launch_form<D, 2, 1, false, Walk>(a, wp, B, st);
    case 64:
      return drop ? launch_form<D, 4, 1, DROPS, Walk>(a, wp, B, st)
                  : launch_form<D, 4, 1, false, Walk>(a, wp, B, st);
    case 128:
      if constexpr (D == 64)
        return drop ? launch_form<D, 4, 2, DROPS, Walk>(a, wp, B, st)
                    : launch_form<D, 4, 2, false, Walk>(a, wp, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
