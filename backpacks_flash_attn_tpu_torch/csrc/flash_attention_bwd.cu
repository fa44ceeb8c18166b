// K5: FlashAttention backward (dq, dk, dv), with the dropout mask
// regenerated from its seed.
//
// Replaces the TPU kernel backpacks_flash_attn_tpu/ops/flash_attention.py
// _flash_bwd (:794) in its default form, the single-pass Pallas body
// _flash_bwd_scratch_kernel (:681): each (query tile, key tile) pair is
// recomputed once and feeds all three gradients (5 products), dq summed in
// f32 across the key tiles. (The no-bias contract of _flash_bwd_fused_kernel
// :590 and of the split _flash_bwd_dq_kernel :460 + _flash_bwd_dkv_kernel
// :523 is the same function.) Head dim 64 (a compile-time constant: other
// head dims become instances), sq == sk, causal or not, bf16 or f32 in and
// out, f32 accumulators.
//
// Bound on the H100: at the training shape (32, 12, 512, 64) the bytes,
// q, k, v, out and dO read and dq, dk, dv written once (8 x 25 MB) plus
// the LSE, 0.0603 ms, against ~16 GFLOP of the five causal products
// (0.016 ms); at train-8k's (2, 12, 8192, 64) the operations: 10 x pairs
// x 64 = 5.15e11 FLOP over the causal half, 0.52 ms at 989 TFLOP/s.
// Against the operations, this design makes each tile's scores, mask and
// keep bits once (5 products, not the split form's 7) on mma.sync, the
// loads overlapped by a cp.async ring (wgmma is ROADMAP S6). Against the
// bytes it keeps K, V and the dK/dV sums on chip and reads Q and dO once a
// key tile (mostly from L2); the price is dq's f32 accumulator, zeroed,
// added into and read back (three passes over 4 bytes an element, about
// 0.04 ms at the training shape).
//
// bf16 (the tensor-core route; rows 16-byte aligned, which the wrapper
// ensures) is three launches from one C entry:
// 1. bwd_prep_kernel, one warp a (b, h, row): delta = rowsum(dO * O), the
//    LSE in log2 units, both into (b * H + h, S_pad) tables padded to whole
//    64-query tiles (rows past S: LSE +inf, delta 0, so a padded query row's
//    probabilities are 0 with no test in the main loop), and zeroes the
//    row's f32 dq accumulator (no memset launch).
// 2. bwd_mma_kernel<WARPS, DROP>: one CTA of WARPS warps per (key tile of
//    16 * WARPS keys, head, batch row), a warp owning 16 keys whose K and V
//    rows it keeps as A fragments in registers, K also in shared memory for
//    dq. It walks the 64-query tiles from the causal diagonal to the end:
//    Q, dO and the two per-row tables stream through a 2-stage cp.async
//    ring (tile t + 1 loads while tile t multiplies), one barrier a tile.
//    Per tile, on mma.sync m16n8k16 (bf16 in, f32 accumulators), a warp
//    makes S^T = K Q^T and dP^T = V dO^T once, then p = 2^(s * scale *
//    log2 e - lse * log2 e), the keep bit once (common.cuh dropout_keep at
//    the absolute query and key positions, bh = b * H + h) and dS = p * (dp
//    - delta), and accumulates dV += P_drop^T dO and dK += dS^T Q in
//    registers (P and dS turned into A fragments without touching shared
//    memory). dS^T goes to shared memory once as bf16 (key-major, 144-byte
//    rows: conflict-free stores), into one of two buffers, and after the
//    next tile's barrier each warp multiplies its share of dQ_tile = dS K
//    (A fragments by ldmatrix.trans from dS^T, B by ldmatrix.trans from K)
//    and adds the f32 partial into a (b, s, h, 64) f32 accumulator, two
//    lanes trading halves so that each adds four adjacent columns with one
//    16-byte atomic (atomicAdd on float4, sm_90). Dropout is a template
//    argument, so no tile branches on it; the mask is applied only on
//    tiles that straddle the diagonal or the sequence's end (a
//    warp-uniform branch between two instances of the elementwise pass); a
//    warp whose keys lie past every query of a tile skips its products and
//    zeroes its dS^T rows, and the dQ product stops at the last key any
//    query of the tile sees. The key tiles with the most query tiles
//    launch first (the key tile is blockIdx.y), so the causal tail does not
//    leave SMs idle. The wrapper picks WARPS: 8 (128-key tiles, half the
//    dq atomics a query row receives) up to s 1024, 4 (two CTAs an SM)
//    past it, each the faster there on the H100 (bench_flash_bwd.py).
// 3. dq_convert_kernel: dq = accumulator * scale in bf16.
// dk and dv are deterministic (each CTA owns its keys' rows). dq is not:
// the order in which the key tiles' f32 partials land varies from run to
// run, so dq may differ in its last bits between two runs on the same
// inputs (each run holds the 2x rule).
//
// f32 operands take the SIMT kernels (delta_kernel, dkdv_simt_kernel,
// dq_simt_kernel), the training CLI's f32 default: 32-row tiles of f32 in
// shared memory, 256 threads, eight threads a row, each making 4 of the
// row's 32 scores per tile and holding 8 of its 64 gradient columns; every
// product in f32, scores recomputed in both kernels, no atomics.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int D = 64, LD = D + 8;  // 144-byte smem rows: 16-byte aligned, ldmatrix conflict-free

// ------------------------------------------------------------- f32: delta

// delta = rowsum(dO * O) per (b, h, row), one warp a row
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

// ------------------------------------------------------------- bf16: tensor cores

constexpr int BQ = 64;       // queries a tile
constexpr int kStages = 2;   // query tiles in the cp.async ring
// a ring stage: Q and dO (BQ x LD bf16 each), then the tile's LSE (log2
// units) and delta (BQ f32 each)
constexpr int kStageBytes = 2 * BQ * LD * 2 + 2 * BQ * 4;

struct BwdArgs {
  const bf16 *q, *k, *v, *dout;
  const float *lse2, *delta;  // (B * H, S_pad): LSE * log2 e (+inf past S), rowsum(dO * O)
  float* dq_acc;              // (B, S, H, D) f32, zeroed by the prep kernel
  bf16 *dk, *dv;              // (B, S, H, D), contiguous
  int H, S, S_pad, causal;
  Strides sq, sk, sv, sd;
  float scale, scale_log2;
  DropoutParams drop;
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
// MASK: the tile straddles the diagonal or the sequence's end, so pairs
// past either give p = 0 (a template argument: no other tile tests them).
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
        if (MASK && (key >= a.S || (a.causal && key > qry))) p = 0.f;
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
  if (q0 + mq >= a.S) return;  // warp-uniform: every row of the warp is padding
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
  float* dst = a.dq_acc + ((static_cast<long long>(b) * a.S + row) * a.H + h) * D + c0 +
               4 * (tq >> 1);
#pragma unroll
  for (int nf = 0; nf < NQF; ++nf) {
    const float r0 = __shfl_xor_sync(0xffffffffu, odd ? acc[nf][0] : acc[nf][2], 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, odd ? acc[nf][1] : acc[nf][3], 1);
    if (row < a.S)
      atomicAdd(reinterpret_cast<float4*>(dst + nf * 8),
                odd ? make_float4(r0, r1, acc[nf][2], acc[nf][3])
                    : make_float4(acc[nf][0], acc[nf][1], r0, r1));
  }
}

// 2. One CTA per (key tile of 16 * WARPS keys, head, batch row): blockIdx.x
// = b * H + h, blockIdx.y = the key tile (tile 0 has the most query tiles
// under causal masking, and launches first)
template <int WARPS, bool DROP>
__global__ void __launch_bounds__(32 * WARPS, 8 / WARPS) bwd_mma_kernel(const BwdArgs a) {
  constexpr int BK = 16 * WARPS, kThreads = 32 * WARPS;
  static_assert(BK % BQ == 0, "a key tile starts on a query tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // BK x LD, the whole kernel
  bf16* dsT = Ks + BK * LD;  // 2 x BK x LD: dS^T of tiles t and t - 1 (V at first)
  unsigned char* ring = reinterpret_cast<unsigned char*>(dsT + 2 * BK * LD);

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int k0 = blockIdx.y * BK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
  const int kw = k0 + 16 * warp;  // the warp's first key
  const long long bh = static_cast<long long>(b) * a.H + h;
  const int q_first = a.causal ? k0 : 0;  // the first query tile any key of the CTA sees
  const int n_tiles = (a.S - q_first + BQ - 1) / BQ;

  const bf16* qb = a.q + b * a.sq.sb + h * a.sq.sh;
  const bf16* db = a.dout + b * a.sd.sb + h * a.sd.sh;
  const float* lb = a.lse2 + bh * a.S_pad;
  const float* dlb = a.delta + bh * a.S_pad;
  auto load_tile = [&](int t) {
    bf16* Qs = reinterpret_cast<bf16*>(ring + (t % kStages) * kStageBytes);
    const int q0 = q_first + t * BQ;
    load_rows_async<BQ, kThreads>(Qs, qb, a.sq.st, q0, a.S);
    load_rows_async<BQ, kThreads>(Qs + BQ * LD, db, a.sd.st, q0, a.S);
    if (threadIdx.x < 2 * BQ / 4) {  // the LSE, then delta: 16 bytes a thread
      const int c = threadIdx.x;
      float* stats = reinterpret_cast<float*>(Qs + 2 * BQ * LD);
      cp_async16(stats + 4 * c, c < BQ / 4 ? lb + q0 + 4 * c : dlb + q0 + 4 * c - BQ);
    }
  };
  // K (kept) and V (read once into registers) go with the first tile's group
  load_rows_async<BK, kThreads>(Ks, a.k + b * a.sk.sb + h * a.sk.sh, a.sk.st, k0, a.S);
  load_rows_async<BK, kThreads>(dsT, a.v + b * a.sv.sb + h * a.sv.sh, a.sv.st, k0, a.S);
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
  auto dq_keys = [&](int q0) { return min(min(BK, a.S - k0), a.causal ? q0 + BQ - k0 : BK); };

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
    const int q0 = q_first + t * BQ;
    if (t > 0)  // tile t - 1's dQ, while other warps may already work on tile t
      dq_tile<WARPS>(a, dsT + ((t - 1) & 1) * BK * LD, Ks, q0 - BQ, dq_keys(q0 - BQ), b, h);
    bf16* my_rows = dsT + ((t & 1) * BK + 16 * warp) * LD;  // the warp's keys' rows of dS^T
    const bf16* Qs = reinterpret_cast<const bf16*>(ring + (t % kStages) * kStageBytes);
    const float* L = reinterpret_cast<const float*>(Qs + 2 * BQ * LD);
    // warp-uniform: whether any (key, query) pair of the warp's keys and the
    // tile is valid, and whether the mask cuts through the tile
    if (kw < a.S && (!a.causal || q0 + BQ - 1 >= kw)) {
      const bool edge = (a.causal && q0 < kw + 15) || kw + 16 > a.S;
      warp_tile<DROP>(dk_acc, dv_acc, ka, va, Qs, Qs + BQ * LD, L, L + BQ, my_rows, a, q0, kw,
                      edge, bh32);
    } else {
      for (int i = lane; i < 16 * (BQ / 8); i += 32)
        *reinterpret_cast<uint4*>(my_rows + (i / (BQ / 8)) * LD + (i % (BQ / 8)) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // dS^T of the last tile is complete
  const int q_last = q_first + (n_tiles - 1) * BQ;
  dq_tile<WARPS>(a, dsT + ((n_tiles - 1) & 1) * BK * LD, Ks, q_last, dq_keys(q_last), b, h);

  const long long o_st = static_cast<long long>(a.H) * D;
  store_rows(a.dk + (static_cast<long long>(b) * a.S * a.H + h) * D, o_st, dk_acc, kw, g, tq,
             a.S, a.scale);
  store_rows(a.dv + (static_cast<long long>(b) * a.S * a.H + h) * D, o_st, dv_acc, kw, g, tq,
             a.S, 1.f);
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

template <int WARPS, bool DROP>
cudaError_t launch_form(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int BK = 16 * WARPS;
  const size_t smem = 3 * BK * LD * sizeof(bf16) + kStages * kStageBytes;
  const cudaError_t err = allow_smem<bwd_mma_kernel<WARPS, DROP>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(B * a.H), static_cast<unsigned>((a.S + BK - 1) / BK));
  bwd_mma_kernel<WARPS, DROP><<<grid, 32 * WARPS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int WARPS>
cudaError_t launch_mma(const BwdArgs& a, int B, cudaStream_t stream) {
  return a.drop.on ? launch_form<WARPS, true>(a, B, stream)
                   : launch_form<WARPS, false>(a, B, stream);
}

// ------------------------------------------------------------- f32 (SIMT)

constexpr int ST = 32, SLD = D + 1, kSimtThreads = 256;

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

// one block per (32-key tile, head, batch row); thread (r, c) = key k0 + r,
// queries c + 8 i of each tile, gradient columns c + 8 j
__global__ void __launch_bounds__(kSimtThreads)
dkdv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int H, int S, Strides sq,
                 Strides sk, Strides sv, Strides sd, float scale, int causal, DropoutParams drop) {
  __shared__ float Ks[ST][SLD], Vs[ST][SLD], Qs[ST][SLD], Ds[ST][SLD];
  __shared__ float Ps[ST][ST + 1], DSs[ST][ST + 1];
  __shared__ float Ls[ST], Dl[ST];
  const int k0 = blockIdx.x * ST, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7, key = k0 + r;
  const long long bh = static_cast<long long>(b) * H + h;
  load_rows(Ks, k + b * sk.sb + h * sk.sh, sk.st, k0, S);
  load_rows(Vs, v + b * sv.sb + h * sv.sh, sv.st, k0, S);
  float dk_acc[D / 8], dv_acc[D / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  const float* qb = q + b * sq.sb + h * sq.sh;
  const float* db = dout + b * sd.sb + h * sd.sh;
  for (int q0 = causal ? k0 : 0; q0 < S; q0 += ST) {
    __syncthreads();  // the previous tiles are consumed (and K, V staged)
    load_rows(Qs, qb, sq.st, q0, S);
    load_rows(Ds, db, sd.st, q0, S);
    for (int i = threadIdx.x; i < ST; i += kSimtThreads) {
      const bool in = q0 + i < S;
      Ls[i] = in ? lse[bh * S + q0 + i] : 0.f;
      Dl[i] = in ? delta[bh * S + q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ST / 8; ++i) {
      const int ql = c + 8 * i, qry = q0 + ql;
      const bool valid = key < S && qry < S && (!causal || key <= qry);
      const float p = valid ? expf(dot64(Ks[r], Qs[ql]) * scale - Ls[ql]) : 0.f;
      float dp = dot64(Vs[r], Ds[ql]), pk = p;
      if (drop.on) {
        const bool keep = dropout_keep(drop, static_cast<uint32_t>(bh),
                                       static_cast<uint32_t>(qry), static_cast<uint32_t>(key));
        pk = keep ? p * drop.inv_keep : 0.f;
        dp = keep ? dp * drop.inv_keep : 0.f;
      }
      Ps[r][ql] = pk;
      DSs[r][ql] = p * (dp - Dl[ql]);
    }
    __syncwarp();  // the row's eight threads share one warp
    for (int ql = 0; ql < ST; ++ql) {
      const float pk = Ps[r][ql], ds = DSs[r][ql];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        dv_acc[j] += pk * Ds[ql][c + 8 * j];
        dk_acc[j] += ds * Qs[ql][c + 8 * j];
      }
    }
  }
  if (key >= S) return;
  const long long o = ((static_cast<long long>(b) * S + key) * H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk[o + c + 8 * j] = dk_acc[j] * scale;
    dv[o + c + 8 * j] = dv_acc[j];
  }
}

// one block per (32-query tile, head, batch row); thread (r, c) = query
// q0 + r, keys c + 8 i of each tile, gradient columns c + 8 j
__global__ void __launch_bounds__(kSimtThreads)
dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, int H, int S, Strides sq, Strides sk, Strides sv,
               Strides sd, float scale, int causal, DropoutParams drop) {
  __shared__ float Qs[ST][SLD], Ds[ST][SLD], Ks[ST][SLD], Vs[ST][SLD];
  __shared__ float DSs[ST][ST + 1];
  const int q0 = blockIdx.x * ST, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7, qry = q0 + r;
  const long long bh = static_cast<long long>(b) * H + h;
  load_rows(Qs, q + b * sq.sb + h * sq.sh, sq.st, q0, S);
  load_rows(Ds, dout + b * sd.sb + h * sd.sh, sd.st, q0, S);
  const float row_lse = qry < S ? lse[bh * S + qry] : 0.f;
  const float row_delta = qry < S ? delta[bh * S + qry] : 0.f;
  float dq_acc[D / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq_acc[j] = 0.f;

  const float* kb = k + b * sk.sb + h * sk.sh;
  const float* vb = v + b * sv.sb + h * sv.sh;
  const int kv_end = causal ? min(S, q0 + ST) : S;
  for (int j0 = 0; j0 < kv_end; j0 += ST) {
    __syncthreads();
    load_rows(Ks, kb, sk.st, j0, S);
    load_rows(Vs, vb, sv.st, j0, S);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ST / 8; ++i) {
      const int kl = c + 8 * i, key = j0 + kl;
      const bool valid = key < S && qry < S && (!causal || key <= qry);
      const float p = valid ? expf(dot64(Qs[r], Ks[kl]) * scale - row_lse) : 0.f;
      float dp = dot64(Ds[r], Vs[kl]);
      if (drop.on)
        dp = dropout_keep(drop, static_cast<uint32_t>(bh), static_cast<uint32_t>(qry),
                          static_cast<uint32_t>(key))
                 ? dp * drop.inv_keep
                 : 0.f;
      DSs[r][kl] = p * (dp - row_delta);
    }
    __syncwarp();
    for (int kl = 0; kl < ST; ++kl) {
      const float ds = DSs[r][kl];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) dq_acc[j] += ds * Ks[kl][c + 8 * j];
    }
  }
  if (qry >= S) return;
  float* drow = dq + ((static_cast<long long>(b) * S + qry) * H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) drow[c + 8 * j] = dq_acc[j] * scale;
}

}  // namespace

// q, k, v, out, dout: (B, S, H, 64) bf16 or f32 (dtype) with the given
// (batch, row, head) strides, bf16 rows 16-byte aligned; lse (B, H, S) f32;
// ws: f32 workspace, bf16: the dq accumulator (B * S * H * 64) then the
// LSE and delta tables (B * H * S_pad each, S_pad = S rounded up to 64);
// f32: delta (B * H * S). dq, dk, dv: contiguous (B, S, H, 64) outputs of
// the operands' dtype. key_tile (bf16): 64 or 128 keys a CTA.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, void* ws, void* dq, void* dk, void* dv, long long B, long long H,
    long long S, long long q_sb, long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh, long long o_sb,
    long long o_st, long long o_sh, long long d_sb, long long d_st, long long d_sh, float scale,
    long long causal, long long seed0, long long seed1, long long thr, float inv_keep,
    long long dropout, long long key_tile, long long dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutParams drop = make_dropout(seed0, seed1, thr, inv_keep, dropout);
  const Strides sq{q_sb, q_st, q_sh}, sk{k_sb, k_st, k_sh}, sv{v_sb, v_st, v_sh},
      so{o_sb, o_st, o_sh}, sd{d_sb, d_st, d_sh};
  const int b = static_cast<int>(B), h = static_cast<int>(H), s = static_cast<int>(S);
  const int c = static_cast<int>(causal);
  const auto* lp = static_cast<const float*>(lse);
  auto* wp = static_cast<float*>(ws);
  if (dtype == DT_BF16) {
    if (key_tile != 64 && key_tile != 128) return static_cast<int>(cudaErrorInvalidValue);
    const int s_pad = (s + BQ - 1) / BQ * BQ;
    BwdArgs a;
    a.q = static_cast<const bf16*>(q);
    a.k = static_cast<const bf16*>(k);
    a.v = static_cast<const bf16*>(v);
    a.dout = static_cast<const bf16*>(dout);
    a.dq_acc = wp;
    float* lse2 = wp + B * S * H * D;
    float* delta = lse2 + B * H * s_pad;
    a.lse2 = lse2;
    a.delta = delta;
    a.dk = static_cast<bf16*>(dk);
    a.dv = static_cast<bf16*>(dv);
    a.H = h;
    a.S = s;
    a.S_pad = s_pad;
    a.causal = c;
    a.sq = sq;
    a.sk = sk;
    a.sv = sv;
    a.sd = sd;
    a.scale = scale;
    a.scale_log2 = scale * kLog2e;
    a.drop = drop;
    const unsigned prep_blocks = static_cast<unsigned>((B * s_pad * H + 7) / 8);
    bwd_prep_kernel<<<prep_blocks, 256, 0, st>>>(static_cast<const bf16*>(out), a.dout, lp, lse2,
                                                 delta, wp, b, h, s, s_pad, so, sd);
    cudaError_t err = key_tile == 128 ? launch_mma<8>(a, b, st) : launch_mma<4>(a, b, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long n4 = B * S * H * D / 4;
    const unsigned conv_blocks =
        static_cast<unsigned>((n4 + 255) / 256 < 132 * 16 ? (n4 + 255) / 256 : 132 * 16);
    dq_convert_kernel<<<conv_blocks, 256, 0, st>>>(reinterpret_cast<const float4*>(wp),
                                                   static_cast<uint2*>(dq), n4, scale);
  } else if (dtype == DT_F32) {
    const auto* qp = static_cast<const float*>(q);
    const auto* kp = static_cast<const float*>(k);
    const auto* vp = static_cast<const float*>(v);
    const auto* dp = static_cast<const float*>(dout);
    const unsigned delta_blocks = static_cast<unsigned>((B * S * H + 7) / 8);
    delta_kernel<<<delta_blocks, 256, 0, st>>>(static_cast<const float*>(out), dp, wp, b, h, s,
                                               so, sd);
    const dim3 grid(static_cast<unsigned>((S + ST - 1) / ST), static_cast<unsigned>(H),
                    static_cast<unsigned>(B));
    dkdv_simt_kernel<<<grid, kSimtThreads, 0, st>>>(qp, kp, vp, dp, lp, wp,
                                                    static_cast<float*>(dk),
                                                    static_cast<float*>(dv), h, s, sq, sk, sv, sd,
                                                    scale, c, drop);
    dq_simt_kernel<<<grid, kSimtThreads, 0, st>>>(qp, kp, vp, dp, lp, wp, static_cast<float*>(dq),
                                                  h, s, sq, sk, sv, sd, scale, c, drop);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
