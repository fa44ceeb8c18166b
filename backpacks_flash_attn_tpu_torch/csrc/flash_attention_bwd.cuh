// The single-pass tensor-core FlashAttention backward of K5
// (flash_attention_bwd.cu) and K9 (blocksparse_attention_bwd.cu): one set
// of kernels, two walks over the query tiles.
//
//   DenseQueries  K5: the 64-query tiles from the key tile's diagonal
//                 (causal) or 0 to the end.
//   (K9's)        the key block's list of active query blocks, each split
//                 into 64-query tiles (blocksparse_attention_bwd.cu
//                 SparseQueries).
//
// A walk gives the main kernel its key tile (k0, from blockIdx.y), the
// number of query tiles it visits and the first row of tile t. The
// cp.async ring prefetches tile t + 1 of the walk while tile t multiplies,
// and dQ of tile t - 1 goes out after the next barrier, whatever rows
// either starts at. Queries and keys have their own lengths (Sq, Sk), and
// K5's ring forms their own offsets (BwdArgs q_offsets, k_offsets,
// bh_offset: a chunk pair of a sequence split over ranks). The
// design notes (tiles, the dQ atomics, the masks) are in
// flash_attention_bwd.cu.
//
// Three launches from a C entry (bwd_bf16 below): bwd_prep_kernel (delta,
// the LSE in log2 units, the zeroed dq accumulator), bwd_mma_kernel and
// dq_convert_kernel. dk and dv are deterministic; dq is not (the order in
// which the key tiles' f32 partials land varies between runs).
//
// The head dim D (64, 80, 96 or 128) is a template argument: Q, dO, K and
// V rows of D + 8 bf16 in shared memory (the pitches of
// flash_attention.cuh), dS^T at its own pitch of BQ + 8 (it is keys x
// queries, whatever D is). At D = 64 a warp keeps its K and V A fragments
// in registers and V passes through the dS^T buffers; past 64 the dK and
// dV accumulators alone take D registers a thread, so K and V stay in
// shared memory (V in a buffer of its own) and the fragments are read by
// ldmatrix at every tile.
#pragma once

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// a row's lane pairs: lane l takes columns 2l, 2l + 1, then 64 further on
// while they lie below D (one pair at D = 64; lanes 0-7 take a second at
// D = 80)
template <int D>
__device__ __forceinline__ bool pair_in(int c0, int lane) {
  return c0 + 64 <= D || c0 + 2 * lane < D;
}

// delta = rowsum(dO * O) per (b, h, row) of f32 operands, one warp a row
// (the f32 routes of K5 and K9)
template <int D>
__global__ void __launch_bounds__(256)
delta_kernel(const float* __restrict__ out, const float* __restrict__ dout,
             float* __restrict__ delta, int B, int H, int S, Strides so, Strides sd) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(B) * S * H) return;
  const int h = static_cast<int>(row % H);
  const int i = static_cast<int>((row / H) % S);
  const int b = static_cast<int>(row / (static_cast<long long>(H) * S));
  const float* o = out + b * so.sb + i * so.st + h * so.sh + 2 * lane;
  const float* g = dout + b * sd.sb + i * sd.st + h * sd.sh + 2 * lane;
  float part;  // (the first pair is every lane's)
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += 64)
    if (pair_in<D>(c0, lane)) {
      const float x = o[c0] * g[c0] + o[c0 + 1] * g[c0 + 1];
      part = c0 == 0 ? x : part + x;
    }
  const float v = warp_sum(part);
  if (lane == 0) delta[(static_cast<long long>(b) * H + h) * S + i] = v;
}

inline cudaError_t launch_delta(const void* out, const void* dout, float* delta, long long B,
                                long long H, long long S, long long d, Strides so, Strides sd,
                                cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((B * S * H + 7) / 8);
  const auto* o = static_cast<const float*>(out);
  const auto* g = static_cast<const float*>(dout);
  const int b = static_cast<int>(B), h = static_cast<int>(H), s = static_cast<int>(S);
  return with_head_dim(d, [&](auto D) {
    delta_kernel<D><<<blocks, 256, 0, st>>>(o, g, delta, b, h, s, so, sd);
    return cudaGetLastError();
  });
}

// The SIMT kernels of the f32 routes (K5's flash_attention_bwd.cu, K9's
// blocksparse_attention_bwd.cu): 32-row tiles of f32, 256 threads.
constexpr int ST = 32, kSimtThreads = 256;

// 32 rows from r0 of a row-strided f32 matrix into shared memory; rows at
// or past S are zero
template <int D>
__device__ __forceinline__ void load_rows(float (*dst)[D + 1], const float* base, long long st,
                                          int r0, int S) {
  for (int idx = threadIdx.x; idx < ST * D; idx += kSimtThreads) {
    const int rr = idx / D, dd = idx % D;
    dst[rr][dd] = r0 + rr < S ? base[(r0 + rr) * st + dd] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 16
  for (int dd = 0; dd < D; ++dd) acc += a[dd] * b[dd];
  return acc;
}

// the D-wide tiles of the dK/dV and dQ kernels (Q, dO, K, V: 32 rows of D
// + 1 floats each), and whether each kernel's tiles fit the static limit
template <int D>
constexpr int kSimtDynFloats = 4 * ST * (D + 1);
template <int D>
constexpr bool kDkdvStatic =
    4 * (kSimtDynFloats<D> + 2 * ST * (ST + 1) + 2 * ST) <= kStaticSmemBytes;
template <int D>
constexpr bool kDqStatic = 4 * (kSimtDynFloats<D> + ST * (ST + 1)) <= kStaticSmemBytes;

// one warp's 16 rows of a gradient from its accumulators, times mult
template <int NF>
__device__ __forceinline__ void store_rows(bf16* dst, long long row_stride,
                                           const float (&c)[NF][4], int r0, int g, int tq,
                                           int S, float mult) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= S) continue;
#pragma unroll
    for (int ni = 0; ni < NF; ++ni)
      *reinterpret_cast<__nv_bfloat162*>(dst + row * row_stride + ni * 8 + 2 * tq) =
          __floats2bfloat162_rn(c[ni][2 * half] * mult, c[ni][2 * half + 1] * mult);
  }
}

constexpr int BQ = 64;       // queries a tile
constexpr int kStages = 2;   // query tiles in the cp.async ring
constexpr int LDT = BQ + 8;  // the dS^T rows' pitch (bf16): 144 bytes, conflict-free
// a ring stage: Q and dO (BQ x (D + 8) bf16 each), then the tile's LSE
// (log2 units) and delta (BQ f32 each)
template <int D>
constexpr int kStageBytes = 2 * BQ * (D + 8) * 2 + 2 * BQ * 4;
// whether K and V stay in shared memory (their A fragments read at every
// tile) instead of registers
template <int D>
constexpr bool kKVInSmem = D > 64;

struct BwdArgs {
  const bf16 *q, *k, *v, *dout;
  const float *lse2, *delta;  // (B * H, Sq_pad): LSE * log2 e (+inf past Sq), rowsum(dO * O)
  float* dq_acc;              // (B, Sq, H, D) f32, zeroed by the prep kernel
  bf16 *dk, *dv;              // (B, Sk, H, D), contiguous
  int H, Sq, Sk, Sq_pad, causal;
  Strides sq, sk, sv, sd;
  float scale, scale_log2;
  DropoutParams drop;
  // the ring forms (NULL, NULL, 0: none): the absolute positions of query
  // row 0 and key column 0 of each sequence, and the global index of batch
  // row 0. Causality sees q_offsets[b] - k_offsets[b], the dropout hash the
  // absolute positions and the stream (bh_offset + b) * hash_heads +
  // head_offset + h.
  const int *q_offsets, *k_offsets;
  int bh_offset;
  // the additive score bias and its gradient (the BIAS instances only)
  ScoreBias bias = {};
  // a head shard (tensor parallelism): the call's heads are heads
  // [head_offset, head_offset + H) of hash_heads, so the dropout stream is
  // (bh_offset + b) * hash_heads + head_offset + h, the unsharded call's.
  // K5 sets both (hash_heads = H, head_offset = 0 without a shard); K9 has
  // no dropout and leaves them
  int hash_heads = 0;
  int head_offset = 0;
};

// where sequence b's pairs sit: rel = q_off - k_off (key u is visible to
// query i at u <= i + rel, causal), the absolute positions of query row 0
// and key column 0, and its dropout stream of head h
struct PairPos {
  int rel, q_abs, k_abs;
  uint32_t bh;
  __device__ __forceinline__ PairPos(const BwdArgs& a, int b, int h)
      : rel(0),
        q_abs(a.q_offsets ? a.q_offsets[b] : 0),
        k_abs(a.k_offsets ? a.k_offsets[b] : 0),
        bh(static_cast<uint32_t>((a.bh_offset + b) * a.hash_heads + a.head_offset + h)) {
    rel = q_abs - k_abs;
  }
};

// floor(x / m) * m for any sign of x (m > 0)
__device__ __forceinline__ int floor_to(int x, int m) {
  return (x >= 0 ? x / m : -((-x + m - 1) / m)) * m;
}

// K5's walk: the 64-query tiles from the first any key of the CTA sees
// (causal: the tile of query k0 - rel, its own first key less the
// sequence's relative offset, at least 0) to Sq; none where that lies past
// Sq (a ring pair whose keys all lie after its queries). The key tiles in
// blockIdx.y order (tile 0 has the most query tiles under causal masking,
// and launches first)
struct DenseQueries {
  struct Params {};
  int k0, first, n;
  __device__ __forceinline__ DenseQueries(const Params&, const BwdArgs& a, int BK)
      : k0(blockIdx.y * BK),
        first(a.causal ? max(floor_to(k0 - PairPos(a, blockIdx.x / a.H, 0).rel, BQ), 0) : 0),
        n(max((a.Sq - first + BQ - 1) / BQ, 0)) {}
  __device__ __forceinline__ int tiles() const { return n; }
  __device__ __forceinline__ int q0(int t) const { return first + t * BQ; }
};

// 1. delta, the LSE in log2 units and the zeroed dq accumulator; one warp
// a (b, h, row), rows up to S_pad, consecutive warps on consecutive rows
// (so the LSE and the tables move in whole sectors)
template <int D>
__global__ void __launch_bounds__(256)
bwd_prep_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ lse2,
                float* __restrict__ delta, float* __restrict__ dq_acc, int B, int H, int S,
                int S_pad, Strides so, Strides sd) {
  const int lane = threadIdx.x & 31;
  const long long t = static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (t >= static_cast<long long>(B) * H * S_pad) return;
  const int i = static_cast<int>(t % S_pad);
  const int h = static_cast<int>((t / S_pad) % H);
  const int b = static_cast<int>(t / (static_cast<long long>(H) * S_pad));
  if (i >= S) {
    if (lane == 0) {
      lse2[t] = INFINITY;
      delta[t] = 0.f;
    }
    return;
  }
  const bf16* op = out + b * so.sb + i * so.st + h * so.sh + 2 * lane;
  const bf16* gp = dout + b * sd.sb + i * sd.st + h * sd.sh + 2 * lane;
  float* acc = dq_acc + ((static_cast<long long>(b) * S + i) * H + h) * D + 2 * lane;
  float part;  // (the first pair is every lane's)
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += 64)
    if (pair_in<D>(c0, lane)) {
      const float2 o = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(op + c0));
      const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gp + c0));
      const float x = o.x * g.x + o.y * g.y;
      part = c0 == 0 ? x : part + x;
      *reinterpret_cast<float2*>(acc + c0) = make_float2(0.f, 0.f);
    }
  const float v = warp_sum(part);
  if (lane == 0) {
    lse2[t] = lse[(static_cast<long long>(b) * H + h) * S + i] * kLog2e;
    delta[t] = v;
  }
}

// p, the keep bits and dS of one warp's S^T and dP^T (16 keys x BQ
// queries) as A fragments over the queries: pa = P after dropout, dsa = dS.
// MASK: the tile straddles the diagonal or the keys' end, so pairs past
// either give p = 0 (a template argument: no other tile tests them).
// BIAS: st arrives in log2 units with the bias in it (add_bias), each
// pair's f32 dS goes to dbias_bh (the (b, h) slice of a.bias.grad, or
// NULL) once (the pair belongs to this warp alone, so no atomics), and
// dropout is a warp-uniform branch on a.drop.on (the bias instances are
// built with DROP only, which halves their number).
template <bool DROP, bool MASK, bool BIAS>
__device__ __forceinline__ void tile_probs(uint32_t (&pa)[BQ / 16][4], uint32_t (&dsa)[BQ / 16][4],
                                           const float (&st)[BQ / 8][4],
                                           const float (&dpt)[BQ / 8][4], const float* L,
                                           const float* Dl, const BwdArgs& a, int q0, int kw,
                                           const PairPos& pp, float* dbias_bh) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  // dS's rows in dbias: this lane's first query of the tile and its keys
  float* drow = nullptr;
  if constexpr (BIAS)
    if (dbias_bh) drow = dbias_bh + static_cast<long long>(q0 + 2 * tq) * a.Sk + kw + g;
#pragma unroll
  for (int nf = 0; nf < BQ / 8; ++nf) {
    const float2 lv = *reinterpret_cast<const float2*>(L + nf * 8 + 2 * tq);
    const float2 dl = *reinterpret_cast<const float2*>(Dl + nf * 8 + 2 * tq);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = kw + g + 8 * half;
      float pv[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qry = q0 + nf * 8 + 2 * tq + e;
        float p;
        if constexpr (BIAS)
          p = ex2(st[nf][2 * half + e] - (e ? lv.y : lv.x));
        else
          p = ex2(fmaf(st[nf][2 * half + e], a.scale_log2, -(e ? lv.y : lv.x)));
        if (MASK && (key >= a.Sk || (a.causal && key > qry + pp.rel))) p = 0.f;
        float dp = dpt[nf][2 * half + e];
        pv[e] = p;
        if (DROP && (!BIAS || a.drop.on)) {
          const bool keep = dropout_keep(a.drop, pp.bh, static_cast<uint32_t>(pp.q_abs + qry),
                                         static_cast<uint32_t>(pp.k_abs + key));
          pv[e] = keep ? p * a.drop.inv_keep : 0.f;
          dp = keep ? dp * a.drop.inv_keep : 0.f;
        }
        ds[e] = p * (dp - (e ? dl.y : dl.x));
        if constexpr (BIAS)
          if (drow && qry < a.Sq && key < a.Sk)
            drow[(nf * 8 + e) * a.Sk + 8 * half] = ds[e];
      }
      to_a(pa, nf, half, pv[0], pv[1]);
      to_a(dsa, nf, half, ds[0], ds[1]);
    }
  }
}

// With a bias: one warp's S^T (16 keys x BQ queries) into log2 units with
// the bias in them, s * scale log2 e + bias * log2 e, read at the bias's
// strides straight into the accumulator layout (queries clamped below Sq:
// a padded query's LSE is +inf; keys below Sk: a key past it is masked),
// before tile_probs, so that its registers hold no bias addresses.
__device__ __forceinline__ void add_bias(float (&st)[BQ / 8][4], const float* bias_bh,
                                         const BwdArgs& a, int q0, int kw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float* bcol = bias_bh + min(kw + g + 8 * half, a.Sk - 1);
#pragma unroll
    for (int nf = 0; nf < BQ / 8; ++nf)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qry = min(q0 + nf * 8 + 2 * tq + e, a.Sq - 1);
        st[nf][2 * half + e] =
            fmaf(st[nf][2 * half + e], a.scale_log2, __ldg(bcol + qry * a.bias.sq) * kLog2e);
      }
  }
}

// k-step ks of one warp's S^T = K Q^T and dP^T = V dO^T (16 keys x BQ
// queries), from K's and V's A fragments kf and vf
template <int D>
__device__ __forceinline__ void st_dpt_step(float (&st)[BQ / 8][4], float (&dpt)[BQ / 8][4],
                                            const uint32_t* kf, const uint32_t* vf,
                                            const bf16* Qs, const bf16* Ds, int ks) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int np = 0; np < BQ / 16; ++np) {
    // B fragments of two 8-query blocks of Q^T and of dO^T (rows [q][d])
    const int off =
        (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + ks * 16 + ((lane >> 3) & 1) * 8;
    uint32_t bq[4], bd[4];
    ldmatrix_x4(bq, Qs + off);
    ldmatrix_x4(bd, Ds + off);
    mma_16816(st[2 * np], kf, bq);
    mma_16816(st[2 * np + 1], kf, bq + 2);
    mma_16816(dpt[2 * np], vf, bd);
    mma_16816(dpt[2 * np + 1], vf, bd + 2);
  }
}

// One warp's 16 keys against one query tile: S^T and dP^T, then p, the
// keep bits and dS once; dS^T (bf16) into the warp's rows of dst; dV and dK
// accumulated. L and Dl: the tile's LSE (log2 units) and delta. K's and V's
// A fragments: ka and va (registers), or, at kKVInSmem<D>, by ldmatrix from
// the warp's 16 rows at Kw and Vw.
template <int D, bool DROP, bool BIAS>
__device__ __forceinline__ void warp_tile(float (&dk)[D / 8][4], float (&dv)[D / 8][4],
                                          const uint32_t (&ka)[D / 16][4],
                                          const uint32_t (&va)[D / 16][4], const bf16* Kw,
                                          const bf16* Vw, const bf16* Qs, const bf16* Ds,
                                          const float* L, const float* Dl, bf16* dst,
                                          const BwdArgs& a, int q0, int kw, bool edge,
                                          const PairPos& pp, const float* bias_bh,
                                          float* dbias_bh) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  float st[BQ / 8][4], dpt[BQ / 8][4];  // 16 keys x BQ queries
  zero(st);
  zero(dpt);
  if constexpr (kKVInSmem<D>) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t kf[4], vf[4];
      const int off = (lane & 15) * LD + ks * 16 + (lane >> 4) * 8;
      ldmatrix_x4(kf, Kw + off);
      ldmatrix_x4(vf, Vw + off);
      st_dpt_step<D>(st, dpt, kf, vf, Qs, Ds, ks);
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) st_dpt_step<D>(st, dpt, ka[ks], va[ks], Qs, Ds, ks);
  }
  if constexpr (BIAS) add_bias(st, bias_bh, a, q0, kw);
  uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
  if (edge)  // warp-uniform
    tile_probs<DROP, true, BIAS>(pa, dsa, st, dpt, L, Dl, a, q0, kw, pp, dbias_bh);
  else
    tile_probs<DROP, false, BIAS>(pa, dsa, st, dpt, L, Dl, a, q0, kw, pp, dbias_bh);
  // dS^T (keys x queries) for the dQ product: the pairs as the A fragments
  // hold them (to_a's slots); rows of 144 bytes, so the warp's 32 stores
  // of a step hit 32 banks
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<uint32_t*>(dst + (g + 8 * (e & 1)) * LDT + (2 * kk + (e >> 1)) * 8 +
                                   2 * tq) = dsa[kk][e];
  mma_ab<D / 8>(dv, pa, Ds, LD, lane);
  mma_ab<D / 8>(dk, dsa, Qs, LD, lane);
}

// dQ_tile = dS (BQ x nk keys, from dS^T in shared memory) K, added into the
// f32 accumulator: warp w takes query rows 16 (w % 4) .. + 15 and the
// (w / 4)-th of the WARPS / 4 column groups (D / 8 n-fragments split
// evenly; an odd count a warp ends on one 8-column fragment). Every lane of
// the warp calls it.
template <int D, int WARPS>
__device__ __forceinline__ void dq_tile(const BwdArgs& a, const bf16* dsT, const bf16* Ks, int q0,
                                        int nk, int b, int h) {
  static_assert((D / 8) % (WARPS / 4) == 0, "whole fragments a column group");
  constexpr int LD = D + 8;
  constexpr int NQF = (D / 8) / (WARPS / 4);  // n-fragments of 8 columns a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
  const int mq = 16 * (warp & 3), c0 = (warp >> 2) * NQF * 8;
  if (q0 + mq >= a.Sq) return;  // warp-uniform: every row of the warp is padding
  float acc[NQF][4];
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < WARPS; ++kk) {  // 16 keys a step
    if (kk * 16 >= nk) break;
    uint32_t af[4];
    ldmatrix_x4_trans(af, dsT + (kk * 16 + (lane & 7) + 8 * (lane >> 4)) * LDT + mq +
                              8 * ((lane >> 3) & 1));
#pragma unroll
    for (int nj = 0; nj < NQF / 2; ++nj) {
      uint32_t bfr[4];
      ldmatrix_x4_trans(bfr, Ks + (kk * 16 + (lane & 15)) * LD + c0 + nj * 16 + (lane >> 4) * 8);
      mma_16816(acc[2 * nj], af, bfr);
      mma_16816(acc[2 * nj + 1], af, bfr + 2);
    }
    if constexpr (NQF % 2 == 1) {  // the last 8 columns: rows from lanes 0-15
      uint32_t bfr[2];
      ldmatrix_x2_trans(bfr, Ks + (kk * 16 + (lane & 15)) * LD + c0 + (NQF - 1) * 8);
      mma_16816(acc[NQF - 1], af, bfr);
    }
  }
  // lanes tq and tq ^ 1 trade halves, so that each holds four adjacent
  // columns of one row (the even lane row g, the odd one row g + 8) and
  // adds them with one 16-byte atomic
  const bool odd = tq & 1;
  const int row = q0 + mq + g + 8 * odd;
  float* dst = a.dq_acc + ((static_cast<long long>(b) * a.Sq + row) * a.H + h) * D + c0 +
               4 * (tq >> 1);
#pragma unroll
  for (int nf = 0; nf < NQF; ++nf) {
    const float r0 = __shfl_xor_sync(0xffffffffu, odd ? acc[nf][0] : acc[nf][2], 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, odd ? acc[nf][1] : acc[nf][3], 1);
    if (row < a.Sq)
      atomicAdd(reinterpret_cast<float4*>(dst + nf * 8),
                odd ? make_float4(r0, r1, acc[nf][2], acc[nf][3])
                    : make_float4(acc[nf][0], acc[nf][1], r0, r1));
  }
}

// The main kernel's shared memory: K (BK x LD, the whole kernel), at
// kKVInSmem<D> V (BK x LD) too, the two dS^T buffers (2 x BK x LDT; at D =
// 64, where LD = LDT, V passes through them first), then the ring.
template <int D>
constexpr size_t bwd_smem_bytes(int BK) {
  return ((kKVInSmem<D> ? 2 : 1) * BK * (D + 8) + 2 * BK * LDT) * sizeof(bf16) +
         kStages * kStageBytes<D>;
}

// 2. One CTA per (key tile of 16 * WARPS keys, head, batch row): blockIdx.x
// = b * H + h; Walk picks the key tile from blockIdx.y and the query tiles
// (DenseQueries above, K9's SparseQueries). BIAS: whether a.bias enters
// the scores and dbias is written (K5 only).
template <int D, int WARPS, bool DROP, class Walk, bool BIAS = false>
__global__ void __launch_bounds__(32 * WARPS, 8 / WARPS)
    bwd_mma_kernel(const BwdArgs a, const typename Walk::Params wp) {
  constexpr int BK = 16 * WARPS, kThreads = 32 * WARPS, LD = D + 8;
  static_assert(BK % BQ == 0, "a key tile starts on a query tile");
  static_assert(D % 16 == 0 && D <= 128 && (kKVInSmem<D> || LD == LDT), "a head dim instance");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // BK x LD, the whole kernel
  bf16* Vs = Ks + BK * LD;                       // BK x LD at kKVInSmem<D>
  bf16* dsT = Vs + (kKVInSmem<D> ? BK * LD : 0);  // 2 x BK x LDT: dS^T of tiles t and t - 1
  unsigned char* ring = reinterpret_cast<unsigned char*>(dsT + 2 * BK * LDT);

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const Walk walk(wp, a, BK);
  const int k0 = walk.k0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
  const int kw = k0 + 16 * warp;  // the warp's first key
  const long long bh = static_cast<long long>(b) * a.H + h;
  const int n_tiles = walk.tiles();

  const bf16* qb = a.q + b * a.sq.sb + h * a.sq.sh;
  const bf16* db = a.dout + b * a.sd.sb + h * a.sd.sh;
  const float* lb = a.lse2 + bh * a.Sq_pad;
  const float* dlb = a.delta + bh * a.Sq_pad;
  auto load_tile = [&](int t) {
    bf16* Qs = reinterpret_cast<bf16*>(ring + (t % kStages) * kStageBytes<D>);
    const int q0 = walk.q0(t);
    load_rows_async<BQ, kThreads, D>(Qs, qb, a.sq.st, q0, a.Sq);
    load_rows_async<BQ, kThreads, D>(Qs + BQ * LD, db, a.sd.st, q0, a.Sq);
    if (threadIdx.x < 2 * BQ / 4) {  // the LSE, then delta: 16 bytes a thread
      const int c = threadIdx.x;
      float* stats = reinterpret_cast<float*>(Qs + 2 * BQ * LD);
      cp_async16(stats + 4 * c, c < BQ / 4 ? lb + q0 + 4 * c : dlb + q0 + 4 * c - BQ);
    }
  };
  // K (kept) and V (read once into registers at D = 64, through the dS^T
  // buffers; kept past it) go with the first tile's group
  load_rows_async<BK, kThreads, D>(Ks, a.k + b * a.sk.sb + h * a.sk.sh, a.sk.st, k0, a.Sk);
  load_rows_async<BK, kThreads, D>(kKVInSmem<D> ? Vs : dsT,
                                   a.v + b * a.sv.sb + h * a.sv.sh, a.sv.st, k0, a.Sk);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }

  uint32_t ka[D / 16][4], va[D / 16][4];
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  const PairPos pp(a, b, h);
  const float* bias_bh = BIAS ? a.bias.p + b * a.bias.sb + h * a.bias.sh : nullptr;
  float* dbias_bh = BIAS && a.bias.grad ? a.bias.grad + bh * a.Sq * a.Sk : nullptr;
  // the keys any query of tile q0 sees (causal), and the valid ones
  auto dq_keys = [&](int q0) {
    return min(min(BK, a.Sk - k0), a.causal ? q0 + pp.rel + BQ - k0 : BK);
  };

  int q_prev = 0;  // tile t - 1's first query
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t (and K, V) have landed
    __syncthreads();  // ... for every thread; tile t - 1 is consumed, dS^T of t - 1 complete
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    cp_async_commit();
    if (!kKVInSmem<D> && t == 0) {
      a_frags(ka, Ks, LD, 16 * warp, g, tq);
      a_frags(va, dsT, LD, 16 * warp, g, tq);
      __syncwarp();  // the warp's V rows are read before its lanes overwrite them
    }
    const int q0 = walk.q0(t);
    if (t > 0)  // tile t - 1's dQ, while other warps may already work on tile t
      dq_tile<D, WARPS>(a, dsT + ((t - 1) & 1) * BK * LDT, Ks, q_prev, dq_keys(q_prev), b, h);
    bf16* my_rows = dsT + ((t & 1) * BK + 16 * warp) * LDT;  // the warp's keys' rows of dS^T
    const bf16* Qs = reinterpret_cast<const bf16*>(ring + (t % kStages) * kStageBytes<D>);
    const float* L = reinterpret_cast<const float*>(Qs + 2 * BQ * LD);
    // warp-uniform: whether any (key, query) pair of the warp's keys and the
    // tile is valid, and whether the mask cuts through the tile
    if (kw < a.Sk && (!a.causal || q0 + BQ - 1 + pp.rel >= kw)) {
      const bool edge = (a.causal && q0 + pp.rel < kw + 15) || kw + 16 > a.Sk;
      warp_tile<D, DROP, BIAS>(dk_acc, dv_acc, ka, va, Ks + 16 * warp * LD, Vs + 16 * warp * LD,
                               Qs, Qs + BQ * LD, L, L + BQ, my_rows, a, q0, kw, edge, pp,
                               bias_bh, dbias_bh);
    } else {
      for (int i = lane; i < 16 * (BQ / 8); i += 32)
        *reinterpret_cast<uint4*>(my_rows + (i / (BQ / 8)) * LDT + (i % (BQ / 8)) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    q_prev = q0;
  }
  cp_async_wait<0>();
  if (n_tiles > 0) {  // (a K9 key tile whose column holds no query tile has none)
    __syncthreads();  // dS^T of the last tile is complete
    dq_tile<D, WARPS>(a, dsT + ((n_tiles - 1) & 1) * BK * LDT, Ks, q_prev, dq_keys(q_prev), b,
                      h);
  }

  const long long o_st = static_cast<long long>(a.H) * D;
  store_rows(a.dk + (static_cast<long long>(b) * a.Sk * a.H + h) * D, o_st, dk_acc, kw, g, tq,
             a.Sk, a.scale);
  store_rows(a.dv + (static_cast<long long>(b) * a.Sk * a.H + h) * D, o_st, dv_acc, kw, g, tq,
             a.Sk, 1.f);
}

// 3. dq = accumulator * scale, four elements a thread and step
__global__ void __launch_bounds__(256)
dq_convert_kernel(const float4* __restrict__ acc, uint2* __restrict__ dq, long long n4,
                  float scale) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float4 v = acc[i];
    dq[i] = make_uint2(pack_bf16x2(v.x * scale, v.y * scale),
                       pack_bf16x2(v.z * scale, v.w * scale));
  }
}

template <int D, int WARPS, bool DROP, class Walk, bool BIAS = false>
cudaError_t launch_form(const BwdArgs& a, const typename Walk::Params& wp, int B,
                        cudaStream_t stream) {
  constexpr int BK = 16 * WARPS;
  const size_t smem = bwd_smem_bytes<D>(BK);
  const cudaError_t err = allow_smem<bwd_mma_kernel<D, WARPS, DROP, Walk, BIAS>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(B * a.H), static_cast<unsigned>((a.Sk + BK - 1) / BK));
  bwd_mma_kernel<D, WARPS, DROP, Walk, BIAS><<<grid, 32 * WARPS, smem, stream>>>(a, wp);
  return cudaGetLastError();
}

// The main kernel over key tiles of key_tile (64 or 128) keys; DROPS:
// whether dropout may be on (K9 has none, so its instances are not built)
template <int D, class Walk, bool DROPS, int WARPS, bool BIAS = false>
cudaError_t launch_mma(const BwdArgs& a, const typename Walk::Params& wp, int B,
                       cudaStream_t stream) {
  return DROPS && a.drop.on ? launch_form<D, WARPS, DROPS, Walk, BIAS>(a, wp, B, stream)
                            : launch_form<D, WARPS, false, Walk, BIAS>(a, wp, B, stream);
}

// The bf16 route at head dim D: a (everything but the workspace set) and
// ws, the f32 workspace: the dq accumulator (B * Sq * H * D), then the LSE
// and delta tables (B * H * Sq_pad each, Sq_pad = Sq rounded up to 64).
// out, lse: the forward's (B, Sq, H, D) strided by so and (B, H, Sq) f32.
// BIASES: whether a score bias may be given (K5 only); its instances are
// built at 128-key tiles only, which a call with a bias must ask for.
template <int D, class Walk, bool DROPS, bool BIASES = false>
cudaError_t bwd_bf16(BwdArgs a, const typename Walk::Params& wp, const bf16* out, Strides so,
                     const float* lse, float* ws, bf16* dq, long long B, long long key_tile,
                     cudaStream_t st) {
  if (key_tile != 64 && key_tile != 128) return cudaErrorInvalidValue;
  if (a.bias.p && (!BIASES || key_tile != 128)) return cudaErrorInvalidValue;
  a.Sq_pad = (a.Sq + BQ - 1) / BQ * BQ;
  a.dq_acc = ws;
  float* lse2 = ws + B * a.Sq * a.H * D;
  float* delta = lse2 + B * a.H * a.Sq_pad;
  a.lse2 = lse2;
  a.delta = delta;
  a.scale_log2 = a.scale * kLog2e;
  const int b = static_cast<int>(B);
  const unsigned prep_blocks = static_cast<unsigned>((B * a.Sq_pad * a.H + 7) / 8);
  bwd_prep_kernel<D><<<prep_blocks, 256, 0, st>>>(out, a.dout, lse, lse2, delta, ws, b, a.H,
                                                  a.Sq, a.Sq_pad, so, a.sd);
  cudaError_t err;
  if constexpr (BIASES)
    if (a.bias.p) err = launch_form<D, 8, DROPS, Walk, true>(a, wp, b, st);
  if (!BIASES || !a.bias.p)
    err = key_tile == 128 ? launch_mma<D, Walk, DROPS, 8>(a, wp, b, st)
                          : launch_mma<D, Walk, DROPS, 4>(a, wp, b, st);
  if (err != cudaSuccess) return err;
  const long long n4 = B * a.Sq * a.H * D / 4;
  const unsigned conv_blocks =
      static_cast<unsigned>((n4 + 255) / 256 < 132 * 16 ? (n4 + 255) / 256 : 132 * 16);
  dq_convert_kernel<<<conv_blocks, 256, 0, st>>>(reinterpret_cast<const float4*>(ws),
                                                 reinterpret_cast<uint2*>(dq), n4, a.scale);
  return cudaGetLastError();
}

}  // namespace
