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
// either starts at. Queries and keys have their own lengths (Sq, Sk): K9's
// backward takes sq != sk; K5's wrapper still passes equal ones. The
// design notes (tiles, the dQ atomics, the masks) are in
// flash_attention_bwd.cu.
//
// Three launches from a C entry (bwd_bf16 below): bwd_prep_kernel (delta,
// the LSE in log2 units, the zeroed dq accumulator), bwd_mma_kernel and
// dq_convert_kernel. dk and dv are deterministic; dq is not (the order in
// which the key tiles' f32 partials land varies between runs).
#pragma once

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int D = 64, LD = D + 8;  // 144-byte smem rows: 16-byte aligned, ldmatrix conflict-free

// delta = rowsum(dO * O) per (b, h, row) of f32 operands, one warp a row
// (the f32 routes of K5 and K9)
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
  const float v = warp_sum(o[0] * g[0] + o[1] * g[1]);
  if (lane == 0) delta[(static_cast<long long>(b) * H + h) * S + i] = v;
}

inline cudaError_t launch_delta(const void* out, const void* dout, float* delta, long long B,
                                long long H, long long S, Strides so, Strides sd,
                                cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((B * S * H + 7) / 8);
  delta_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(out),
                                       static_cast<const float*>(dout), delta,
                                       static_cast<int>(B), static_cast<int>(H),
                                       static_cast<int>(S), so, sd);
  return cudaGetLastError();
}

// one warp's 16 rows of a gradient from its accumulators, times mult
__device__ __forceinline__ void store_rows(bf16* dst, long long row_stride,
                                           const float (&c)[D / 8][4], int r0, int g, int tq,
                                           int S, float mult) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= S) continue;
#pragma unroll
    for (int ni = 0; ni < D / 8; ++ni)
      *reinterpret_cast<__nv_bfloat162*>(dst + row * row_stride + ni * 8 + 2 * tq) =
          __floats2bfloat162_rn(c[ni][2 * half] * mult, c[ni][2 * half + 1] * mult);
  }
}

constexpr int BQ = 64;       // queries a tile
constexpr int kStages = 2;   // query tiles in the cp.async ring
// a ring stage: Q and dO (BQ x LD bf16 each), then the tile's LSE (log2
// units) and delta (BQ f32 each)
constexpr int kStageBytes = 2 * BQ * LD * 2 + 2 * BQ * 4;

struct BwdArgs {
  const bf16 *q, *k, *v, *dout;
  const float *lse2, *delta;  // (B * H, Sq_pad): LSE * log2 e (+inf past Sq), rowsum(dO * O)
  float* dq_acc;              // (B, Sq, H, D) f32, zeroed by the prep kernel
  bf16 *dk, *dv;              // (B, Sk, H, D), contiguous
  int H, Sq, Sk, Sq_pad, causal;
  Strides sq, sk, sv, sd;
  float scale, scale_log2;
  DropoutParams drop;
};

// K5's walk: the 64-query tiles from the first any key of the CTA sees
// (its own first key, causal) to Sq; the key tiles in blockIdx.y order
// (tile 0 has the most query tiles under causal masking, and launches
// first)
struct DenseQueries {
  struct Params {};
  int k0, first, n;
  __device__ __forceinline__ DenseQueries(const Params&, const BwdArgs& a, int BK)
      : k0(blockIdx.y * BK), first(a.causal ? k0 : 0), n((a.Sq - first + BQ - 1) / BQ) {}
  __device__ __forceinline__ int tiles() const { return n; }
  __device__ __forceinline__ int q0(int t) const { return first + t * BQ; }
};

// 1. delta, the LSE in log2 units and the zeroed dq accumulator; one warp
// a (b, h, row), rows up to S_pad, consecutive warps on consecutive rows
// (so the LSE and the tables move in whole sectors)
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
  const float2 o = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(op));
  const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gp));
  const float v = warp_sum(o.x * g.x + o.y * g.y);
  *reinterpret_cast<float2*>(dq_acc + ((static_cast<long long>(b) * S + i) * H + h) * D +
                             2 * lane) = make_float2(0.f, 0.f);
  if (lane == 0) {
    lse2[t] = lse[(static_cast<long long>(b) * H + h) * S + i] * kLog2e;
    delta[t] = v;
  }
}

// p, the keep bits and dS of one warp's S^T and dP^T (16 keys x BQ
// queries) as A fragments over the queries: pa = P after dropout, dsa = dS.
// MASK: the tile straddles the diagonal or the keys' end, so pairs past
// either give p = 0 (a template argument: no other tile tests them).
template <bool DROP, bool MASK>
__device__ __forceinline__ void tile_probs(uint32_t (&pa)[BQ / 16][4], uint32_t (&dsa)[BQ / 16][4],
                                           const float (&st)[BQ / 8][4],
                                           const float (&dpt)[BQ / 8][4], const float* L,
                                           const float* Dl, const BwdArgs& a, int q0, int kw,
                                           uint32_t bh) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
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
        float p = ex2(fmaf(st[nf][2 * half + e], a.scale_log2, -(e ? lv.y : lv.x)));
        if (MASK && (key >= a.Sk || (a.causal && key > qry))) p = 0.f;
        float dp = dpt[nf][2 * half + e];
        pv[e] = p;
        if (DROP) {
          const bool keep = dropout_keep(a.drop, bh, static_cast<uint32_t>(qry),
                                         static_cast<uint32_t>(key));
          pv[e] = keep ? p * a.drop.inv_keep : 0.f;
          dp = keep ? dp * a.drop.inv_keep : 0.f;
        }
        ds[e] = p * (dp - (e ? dl.y : dl.x));
      }
      to_a(pa, nf, half, pv[0], pv[1]);
      to_a(dsa, nf, half, ds[0], ds[1]);
    }
  }
}

// One warp's 16 keys against one query tile: S^T and dP^T, then p, the
// keep bits and dS once; dS^T (bf16) into the warp's rows of dst; dV and dK
// accumulated. L and Dl: the tile's LSE (log2 units) and delta.
template <bool DROP>
__device__ __forceinline__ void warp_tile(float (&dk)[D / 8][4], float (&dv)[D / 8][4],
                                          const uint32_t (&ka)[D / 16][4],
                                          const uint32_t (&va)[D / 16][4], const bf16* Qs,
                                          const bf16* Ds, const float* L, const float* Dl,
                                          bf16* dst, const BwdArgs& a, int q0, int kw, bool edge,
                                          uint32_t bh) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  float st[BQ / 8][4], dpt[BQ / 8][4];  // 16 keys x BQ queries
  zero(st);
  zero(dpt);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int np = 0; np < BQ / 16; ++np) {
      // B fragments of two 8-query blocks of Q^T and of dO^T (rows [q][d])
      const int off =
          (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + ks * 16 + ((lane >> 3) & 1) * 8;
      uint32_t bq[4], bd[4];
      ldmatrix_x4(bq, Qs + off);
      ldmatrix_x4(bd, Ds + off);
      mma_16816(st[2 * np], ka[ks], bq);
      mma_16816(st[2 * np + 1], ka[ks], bq + 2);
      mma_16816(dpt[2 * np], va[ks], bd);
      mma_16816(dpt[2 * np + 1], va[ks], bd + 2);
    }
  uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
  if (edge)  // warp-uniform
    tile_probs<DROP, true>(pa, dsa, st, dpt, L, Dl, a, q0, kw, bh);
  else
    tile_probs<DROP, false>(pa, dsa, st, dpt, L, Dl, a, q0, kw, bh);
  // dS^T (keys x queries) for the dQ product: the pairs as the A fragments
  // hold them (to_a's slots); rows of 144 bytes, so the warp's 32 stores
  // of a step hit 32 banks
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<uint32_t*>(dst + (g + 8 * (e & 1)) * LD + (2 * kk + (e >> 1)) * 8 +
                                   2 * tq) = dsa[kk][e];
  mma_ab<D / 8>(dv, pa, Ds, LD, lane);
  mma_ab<D / 8>(dk, dsa, Qs, LD, lane);
}

// dQ_tile = dS (BQ x nk keys, from dS^T in shared memory) K, added into the
// f32 accumulator: warp w takes query rows 16 (w % 4) .. + 15 and the
// (w / 4)-th of the WARPS / 4 column groups. Every lane of the warp calls it.
template <int WARPS>
__device__ __forceinline__ void dq_tile(const BwdArgs& a, const bf16* dsT, const bf16* Ks, int q0,
                                        int nk, int b, int h) {
  constexpr int NQF = 8 / (WARPS / 4);  // n-fragments of 8 columns a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
  const int mq = 16 * (warp & 3), c0 = (warp >> 2) * NQF * 8;
  if (q0 + mq >= a.Sq) return;  // warp-uniform: every row of the warp is padding
  float acc[NQF][4];
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < WARPS; ++kk) {  // 16 keys a step
    if (kk * 16 >= nk) break;
    uint32_t af[4];
    ldmatrix_x4_trans(af, dsT + (kk * 16 + (lane & 7) + 8 * (lane >> 4)) * LD + mq +
                              8 * ((lane >> 3) & 1));
#pragma unroll
    for (int nj = 0; nj < NQF / 2; ++nj) {
      uint32_t bfr[4];
      ldmatrix_x4_trans(bfr, Ks + (kk * 16 + (lane & 15)) * LD + c0 + nj * 16 + (lane >> 4) * 8);
      mma_16816(acc[2 * nj], af, bfr);
      mma_16816(acc[2 * nj + 1], af, bfr + 2);
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

// 2. One CTA per (key tile of 16 * WARPS keys, head, batch row): blockIdx.x
// = b * H + h; Walk picks the key tile from blockIdx.y and the query tiles
// (DenseQueries above, K9's SparseQueries)
template <int WARPS, bool DROP, class Walk>
__global__ void __launch_bounds__(32 * WARPS, 8 / WARPS)
    bwd_mma_kernel(const BwdArgs a, const typename Walk::Params wp) {
  constexpr int BK = 16 * WARPS, kThreads = 32 * WARPS;
  static_assert(BK % BQ == 0, "a key tile starts on a query tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // BK x LD, the whole kernel
  bf16* dsT = Ks + BK * LD;  // 2 x BK x LD: dS^T of tiles t and t - 1 (V at first)
  unsigned char* ring = reinterpret_cast<unsigned char*>(dsT + 2 * BK * LD);

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
    bf16* Qs = reinterpret_cast<bf16*>(ring + (t % kStages) * kStageBytes);
    const int q0 = walk.q0(t);
    load_rows_async<BQ, kThreads>(Qs, qb, a.sq.st, q0, a.Sq);
    load_rows_async<BQ, kThreads>(Qs + BQ * LD, db, a.sd.st, q0, a.Sq);
    if (threadIdx.x < 2 * BQ / 4) {  // the LSE, then delta: 16 bytes a thread
      const int c = threadIdx.x;
      float* stats = reinterpret_cast<float*>(Qs + 2 * BQ * LD);
      cp_async16(stats + 4 * c, c < BQ / 4 ? lb + q0 + 4 * c : dlb + q0 + 4 * c - BQ);
    }
  };
  // K (kept) and V (read once into registers) go with the first tile's group
  load_rows_async<BK, kThreads>(Ks, a.k + b * a.sk.sb + h * a.sk.sh, a.sk.st, k0, a.Sk);
  load_rows_async<BK, kThreads>(dsT, a.v + b * a.sv.sb + h * a.sv.sh, a.sv.st, k0, a.Sk);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }

  uint32_t ka[D / 16][4], va[D / 16][4];
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  const uint32_t bh32 = static_cast<uint32_t>(bh);
  // the keys any query of tile q0 sees (causal), and the valid ones
  auto dq_keys = [&](int q0) { return min(min(BK, a.Sk - k0), a.causal ? q0 + BQ - k0 : BK); };

  int q_prev = 0;  // tile t - 1's first query
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t (and K, V) have landed
    __syncthreads();  // ... for every thread; tile t - 1 is consumed, dS^T of t - 1 complete
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    cp_async_commit();
    if (t == 0) {
      a_frags(ka, Ks, LD, 16 * warp, g, tq);
      a_frags(va, dsT, LD, 16 * warp, g, tq);
      __syncwarp();  // the warp's V rows are read before its lanes overwrite them
    }
    const int q0 = walk.q0(t);
    if (t > 0)  // tile t - 1's dQ, while other warps may already work on tile t
      dq_tile<WARPS>(a, dsT + ((t - 1) & 1) * BK * LD, Ks, q_prev, dq_keys(q_prev), b, h);
    bf16* my_rows = dsT + ((t & 1) * BK + 16 * warp) * LD;  // the warp's keys' rows of dS^T
    const bf16* Qs = reinterpret_cast<const bf16*>(ring + (t % kStages) * kStageBytes);
    const float* L = reinterpret_cast<const float*>(Qs + 2 * BQ * LD);
    // warp-uniform: whether any (key, query) pair of the warp's keys and the
    // tile is valid, and whether the mask cuts through the tile
    if (kw < a.Sk && (!a.causal || q0 + BQ - 1 >= kw)) {
      const bool edge = (a.causal && q0 < kw + 15) || kw + 16 > a.Sk;
      warp_tile<DROP>(dk_acc, dv_acc, ka, va, Qs, Qs + BQ * LD, L, L + BQ, my_rows, a, q0, kw,
                      edge, bh32);
    } else {
      for (int i = lane; i < 16 * (BQ / 8); i += 32)
        *reinterpret_cast<uint4*>(my_rows + (i / (BQ / 8)) * LD + (i % (BQ / 8)) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    q_prev = q0;
  }
  cp_async_wait<0>();
  if (n_tiles > 0) {  // (a K9 key tile whose column holds no query tile has none)
    __syncthreads();  // dS^T of the last tile is complete
    dq_tile<WARPS>(a, dsT + ((n_tiles - 1) & 1) * BK * LD, Ks, q_prev, dq_keys(q_prev), b, h);
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

template <int WARPS, bool DROP, class Walk>
cudaError_t launch_form(const BwdArgs& a, const typename Walk::Params& wp, int B,
                        cudaStream_t stream) {
  constexpr int BK = 16 * WARPS;
  const size_t smem = 3 * BK * LD * sizeof(bf16) + kStages * kStageBytes;
  const cudaError_t err = allow_smem<bwd_mma_kernel<WARPS, DROP, Walk>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(B * a.H), static_cast<unsigned>((a.Sk + BK - 1) / BK));
  bwd_mma_kernel<WARPS, DROP, Walk><<<grid, 32 * WARPS, smem, stream>>>(a, wp);
  return cudaGetLastError();
}

// The main kernel over key tiles of key_tile (64 or 128) keys; DROPS:
// whether dropout may be on (K9 has none, so its instances are not built)
template <class Walk, bool DROPS, int WARPS>
cudaError_t launch_mma(const BwdArgs& a, const typename Walk::Params& wp, int B,
                       cudaStream_t stream) {
  return DROPS && a.drop.on ? launch_form<WARPS, DROPS, Walk>(a, wp, B, stream)
                            : launch_form<WARPS, false, Walk>(a, wp, B, stream);
}

// The bf16 route: a (everything but the workspace set) and ws, the f32
// workspace: the dq accumulator (B * Sq * H * 64), then the LSE and delta
// tables (B * H * Sq_pad each, Sq_pad = Sq rounded up to 64). out, lse:
// the forward's (B, Sq, H, 64) strided by so and (B, H, Sq) f32.
template <class Walk, bool DROPS>
cudaError_t bwd_bf16(BwdArgs a, const typename Walk::Params& wp, const bf16* out, Strides so,
                     const float* lse, float* ws, bf16* dq, long long B, long long key_tile,
                     cudaStream_t st) {
  if (key_tile != 64 && key_tile != 128) return cudaErrorInvalidValue;
  a.Sq_pad = (a.Sq + BQ - 1) / BQ * BQ;
  a.dq_acc = ws;
  float* lse2 = ws + B * a.Sq * a.H * D;
  float* delta = lse2 + B * a.H * a.Sq_pad;
  a.lse2 = lse2;
  a.delta = delta;
  a.scale_log2 = a.scale * kLog2e;
  const int b = static_cast<int>(B);
  const unsigned prep_blocks = static_cast<unsigned>((B * a.Sq_pad * a.H + 7) / 8);
  bwd_prep_kernel<<<prep_blocks, 256, 0, st>>>(out, a.dout, lse, lse2, delta, ws, b, a.H, a.Sq,
                                               a.Sq_pad, so, a.sd);
  const cudaError_t err = key_tile == 128 ? launch_mma<Walk, DROPS, 8>(a, wp, b, st)
                                          : launch_mma<Walk, DROPS, 4>(a, wp, b, st);
  if (err != cudaSuccess) return err;
  const long long n4 = B * a.Sq * a.H * D / 4;
  const unsigned conv_blocks =
      static_cast<unsigned>((n4 + 255) / 256 < 132 * 16 ? (n4 + 255) / 256 : 132 * 16);
  dq_convert_kernel<<<conv_blocks, 256, 0, st>>>(reinterpret_cast<const float4*>(ws),
                                                 reinterpret_cast<uint2*>(dq), n4, a.scale);
  return cudaGetLastError();
}

}  // namespace
