// K6: fused Backpack contextualization, training backward.
//
// Replaces the TPU kernels backpacks_flash_attn_tpu/ops/backpack_kernels.py
// _fused_ctx_bwd (:345; Pallas bodies _fused_ctx_dq_delta_kernel :158 and
// _fused_ctx_dkc_kernel :209). The forward is K4 returning its per-(row,
// head) LSE (fused_contextualization.cu, the counterpart of
// _fused_ctx_fwd_lse :309). With alpha_k[t, j] = exp(scale q_t.k_j -
// lse_k[t]) (causal, per sense head k) and dO the cotangent of the summed
// (b, s, d) output:
//   dP[t, j]   = dO[t] . c_k[j]                   (a d-wide product)
//   delta_k[t] = sum_j alpha dP                   (= dO[t] . O_k[t])
//   dS         = alpha * (dP - delta_k[t])
//   dq = scale dS k,  dk = scale dS^T q,  dc_k = alpha^T dO.
// Neither alpha nor the per-head outputs are stored (the TPU kernel's
// reason: the o_heads residual outweighs alpha whenever d > s), so delta
// takes a d-wide product of its own, and delta is complete before any dS
// is formed (a one-pass dq = sum(alpha dP k) - delta sum(alpha k) cancels
// after rounding alpha dP to bf16).
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s) at the training shape
// (32, 512), nv 16, dnv 48, d 768: the bytes. Content read and dcontent
// written (403 MB each), with q, k, dO, dq, dk and the LSE, are 0.932 GB =
// 0.2783 ms; the function's products (dP and alpha^T dO over d, the three
// 48-wide ones) over the 67.2M causal (head, pair)s are 226 GFLOP = 0.228
// ms. This design makes three d-wide products (dP for delta, dP once more
// for dS, alpha^T dO: ~310 GFLOP), each on wgmma with its operands brought
// by TMA on mbarrier rings; content and dO come from device memory about
// once, and what the passes stream again they read from L2.
//
// bf16 (rows 16-byte aligned, dnv % 8 == 0, dnv <= 64, d % 8 == 0): four
// launches from one C entry, on 64-row tiles, 128-byte-swizzled TMA boxes
// of 64 rows x 64 columns (dnv and d past their ends arrive as zeros):
// 1. ctx_bwd_dp_kernel<false>, delta: one CTA per (64-query tile t, head,
//    batch row), a head's query tiles next to each other in the grid,
//    heaviest first (in head-major order a wave's content tiles came from
//    device memory: 0.72 ms against 0.55). dO_t (64 x d) stays in shared
//    memory as wgmma's K-major A operand (each 64-column box on a barrier
//    of its own, so the first products start as the boxes land); the
//    content tiles c_j of the keys j <= t stream as the K-major B operand
//    through a ring of 64-column boxes, as many stages as fit (8 at d 768),
//    and dP (64 x 64, f32) sums over all of d on wgmma m64n64k16. Two
//    consumer warpgroups take alternate key tiles, their chunks interleaved
//    on the ring, each with its own accumulator; a side ring of four slots
//    brings each key tile k_j for the 48-wide scores (mma.sync, from the
//    query tile's fragments). alpha = 2^(s scale log2 e - lse log2 e) and
//    delta += rowsum(alpha dP) in f32; the warpgroups add their sums in a
//    fixed order. It writes delta and the LSE in log2 units into (b * nv,
//    s_pad) tables (rows past s: delta 0, LSE +inf, so their alphas come
//    out 0) and zeroes its rows of the f32 dq accumulator.
// 2. ctx_bwd_dc_kernel: dc_j[:, slab] = alpha^T dO[:, slab], K4's product
//    (ctx_wgmma_kernel) with the roles swapped: alpha^T (keys x queries)
//    plays P and dO plays content. A CTA owns the key tiles hi = n - 1 - y
//    and lo = y (key tile j sees query tiles j..n-1, so every CTA does the
//    same products), 192 columns of d and a group of sense heads
//    (ops/backpack_kernels._k6_heads: all 16 at the training shape), which
//    it walks with its ring running on across them. Warpgroup 2's first
//    thread keeps a 3-stage ring full by TMA (per stage the dO slab, three
//    boxes; the query tile and its log2 LSEs; at a run's start the key
//    tiles); warpgroups 0 and 1 turn mma.sync scores into alpha^T in wgmma's
//    register A layout and issue m64n192k16 over the N-major dO slab. Over
//    the query tiles [hi, n) warpgroup 0 takes key tile hi and 1 tile lo
//    (one read of dO serves both); over [lo, hi) both take tile lo, 32
//    queries of each stage apiece, and add their sums through an exchange
//    area. Each finished tile is rounded into a swizzled staging tile and
//    leaves by TMA stores, which clip past s and d (the warps' own 4-byte
//    stores of the 403 MB took a third of the pass).
// 3. ctx_bwd_dp_kernel<true>, main: one CTA per (64-key tile j, head, batch
//    row), tile 0 (the most query tiles) first, a wave's heads of one batch
//    row sharing its dO tiles in L2. c_j (64 x d) stays in shared memory as
//    the A operand, the dO tiles of the queries t >= j stream as B, and the
//    side ring brings q_t with its log2 LSEs and deltas. Per query tile:
//    dP^T = c_j dO_t^T once (wgmma), S^T = k_j q_t^T (mma.sync), dS^T =
//    alpha^T (dP^T - delta); dk += dS^T q_t in registers (mma.sync, q_t by
//    ldmatrix.trans; the warpgroups add their dk at the end); dS^T goes to
//    shared memory in bf16 and dq_t += dS k_j is added into the f32
//    accumulator with float4 atomics, as K5 does. This one dP serves dq
//    and dk.
// 4. ctx_bwd_convert_kernel: dq = accumulator * scale in bf16.
// Past d = 1024 the resident operand no longer fits beside the rings: its
// boxes then ride in each stage beside the streamed ones.
// What holds it (probe_k6.py, H100): in the dP passes neither the loads nor
// the products alone (each takes ~80-95% of the pass without the other),
// and the main pass's epilogue (dS, dk, dq) does not overlap its products;
// see PERF.md.
// dk and dcontent are deterministic (each CTA owns its rows and sums in a
// fixed order). dq is not: the order in which the key tiles' f32 partials
// land varies from run to run, so dq may differ in its last bits between
// two runs on the same inputs.
//
// f32 operands (dnv <= 64, any d) take SIMT versions of three launches:
// dq with delta (dP streamed over d twice), dk (dP once more), dcontent in
// 128-column slabs; 32-row tiles of f32 in shared memory, 256 threads,
// eight threads a row, each making 4 of the row's 32 scores per tile.
#include <algorithm>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBox = 64 * 128;  // a TMA box: 64 rows of 64 bf16 (128 bytes), swizzled

// A fragments of rows [r, r + 16) of a swizzled box over its first ksteps
// k16 steps (the m16n8k16 A layout)
__device__ __forceinline__ void box_frags(uint32_t (&a)[4][4], uint32_t box, int r, int ksteps,
                                          int lane) {
  const int m8 = lane >> 3;
#pragma unroll
  for (int kq = 0; kq < 4; ++kq)
    if (kq < ksteps)
      ldsm_x4(a[kq], swz(box, r + (m8 & 1) * 8 + (lane & 7), 2 * kq + (m8 >> 1)));
}

// c (the warp's 16 rows x KW columns) = A B^T over the first ksteps k16
// steps: A in fragments, B the rows [w0, w0 + KW) of a swizzled box
template <int KW>
__device__ __forceinline__ void box_scores(float (&c)[KW / 8][4], const uint32_t (&a)[4][4],
                                           uint32_t box, int w0, int ksteps, int lane) {
  const int m8 = lane >> 3;
  zero(c);
#pragma unroll
  for (int kq = 0; kq < 4; ++kq) {
    if (kq >= ksteps) break;
#pragma unroll
    for (int p = 0; p < KW / 16; ++p) {
      uint32_t bk[4];
      ldsm_x4(bk, swz(box, w0 + 16 * p + 8 * (m8 >> 1) + (lane & 7), 2 * kq + (m8 & 1)));
      mma_16816(c[2 * p], a[kq], bk);
      mma_16816(c[2 * p + 1], a[kq], bk + 2);
    }
  }
}

// c (16 x 64) += A (16 x 64, fragments over k = the box's rows) B, B a
// swizzled box stored [k][n], read through ldmatrix.trans; column pairs of
// 16 from nj_end on are skipped
__device__ __forceinline__ void box_mma_ab(float (&c)[8][4], const uint32_t (&a)[4][4],
                                           uint32_t box, int nj_end, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      if (nj >= nj_end) break;
      uint32_t bfr[4];
      ldsm_x4_t(bfr, swz(box, 16 * kk + (lane & 15), 2 * nj + (lane >> 4)));
      mma_16816(c[2 * nj], a[kk], bfr);
      mma_16816(c[2 * nj + 1], a[kk], bfr + 2);
    }
}

// d (64 x 64, f32, the warpgroup's accumulator fragments) = A (64 x 16) B^T
// (B 64 x 16), both K-major 128-byte-swizzled boxes in shared memory, plus
// d if acc
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// ------------------------------------------------------------- 1, 3. dP passes

constexpr int kDpThreads = 288;  // two consumer warpgroups, a producer warp
constexpr int kMaxStages = 12;
constexpr int kMaxRes = 16;                // resident 64-column boxes: d <= 1024
constexpr uint32_t kSlot = kBox + 1024;    // a side-ring slot: a box, 64 log2 LSEs, 64 deltas
constexpr int kDsLd = 72;                  // dS^T rows (bf16): 144 bytes, conflict-free
constexpr uint32_t kDs = 64 * kDsLd * 2;   // a warpgroup's dS^T
constexpr int kDpBars = 2 * kMaxStages + 8 + 1 + kMaxRes;
constexpr uint32_t kSmemMax = 232448;      // an H100 block's shared memory

// byte offsets from the 1024-aligned base: the resident operand's R boxes
// (none when streamed), the resident 64-row tile of q or k, the side ring
// (four slots: tile ui takes slot ui % 4, so a warpgroup has two), two
// dS^T buffers (the delta pass's and the final dk exchange's scratch too),
// the ring (a box a stage, two when the resident operand is streamed: as
// many stages as fit, up to kMaxStages), the barriers
struct DpLayout {
  uint32_t rs, slots, ds, ring, stage, stages, bars, bytes;
};

__host__ __device__ constexpr DpLayout dp_layout(int R, bool stream_x) {
  const uint32_t rs = stream_x ? 0u : static_cast<uint32_t>(R) * kBox;
  const uint32_t slots = rs + kBox, ds = slots + 4 * kSlot, ring = ds + 2 * kDs;
  const uint32_t stage = stream_x ? 2 * kBox : kBox;
  const uint32_t room = (kSmemMax - 1024 - 8 * kDpBars - ring) / stage;
  const uint32_t stages = room < kMaxStages ? room : kMaxStages;
  const uint32_t bars = ring + stages * stage;
  return DpLayout{rs, slots, ds, ring, stage, stages, bars, 1024 + bars + 8 * kDpBars};
}

static_assert(dp_layout(kMaxRes, false).stages >= 4 && dp_layout(kMaxRes + 1, true).stages >= 4 &&
                  dp_layout(kMaxRes, false).bytes <= kSmemMax &&
                  dp_layout(kMaxRes + 1, true).bytes <= kSmemMax && 64 * 64 * 4 <= 2 * kDs,
              "shared memory");

struct DpArgs {
  const float* lse;  // (B, NV, S), natural log (read by the delta pass)
  float* lse2;       // (B * NV, s_pad): log2 units, +inf past S (written by the delta pass)
  float* delta;      // (B * NV, s_pad): 0 past S (written by the delta pass)
  float* dq_acc;     // (B, S, NV, DNV) f32: zeroed by the delta pass, summed by the main one
  bf16* dk;          // (B, S, NV, DNV)
  int S, NV, DNV, s_pad, n_tiles, R, stream_x;
  float scale, scale_log2;
};

// The ring's stage of chunk c of streamed tile ui: the tiles go in pairs
// (2 p, 2 p + 1), warpgroup ui % 2 taking each, their chunks interleaved
// so that both warpgroups advance together; a last unpaired tile runs
// alone. (Warpgroup 1 lagging half a tile, so that one warpgroup's
// epilogue would fall within the other's products, ran slower.)
__device__ __forceinline__ int dp_stage(int ui, int c, int R, int n_u) {
  const int p = ui >> 1;
  return 2 * p * R + (2 * p + 1 < n_u ? 2 * c + (ui & 1) : c);
}

// dq rows of query tile u (the warp's 16 from 16 w) += dS (read from dS^T in
// shared memory) k_j (the resident key box), into the f32 accumulator: two
// lanes trade halves, so that each adds four adjacent columns of one row
// with one 16-byte atomic
__device__ __forceinline__ void dq_part(const DpArgs& a, const bf16* dsT, uint32_t kbox, int u,
                                        int warp, int b, int head, int nj_end, int lane) {
  const int g = lane >> 2, t = lane & 3, mq = 16 * warp;
  if (64 * u + mq >= a.S) return;  // warp-uniform: every row of the warp is padding
  float acc[8][4];
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // 16 keys a step
    uint32_t af[4];
    ldmatrix_x4_trans(af, dsT + (kk * 16 + (lane & 7) + 8 * (lane >> 4)) * kDsLd + mq +
                              8 * ((lane >> 3) & 1));
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      if (nj >= nj_end) break;
      uint32_t bfr[4];
      ldsm_x4_t(bfr, swz(kbox, 16 * kk + (lane & 15), 2 * nj + (lane >> 4)));
      mma_16816(acc[2 * nj], af, bfr);
      mma_16816(acc[2 * nj + 1], af, bfr + 2);
    }
  }
  const bool odd = t & 1;
  const int row = 64 * u + mq + g + 8 * odd;
  float* dst = a.dq_acc + ((static_cast<long long>(b) * a.S + row) * a.NV + head) * a.DNV +
               4 * (t >> 1);
#pragma unroll
  for (int nf = 0; nf < 8; ++nf) {
    if (8 * nf >= a.DNV) break;
    const float r0 = __shfl_xor_sync(0xffffffffu, odd ? acc[nf][0] : acc[nf][2], 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, odd ? acc[nf][1] : acc[nf][3], 1);
    if (row < a.S)
      atomicAdd(reinterpret_cast<float4*>(dst + 8 * nf),
                odd ? make_float4(r0, r1, acc[nf][2], acc[nf][3])
                    : make_float4(acc[nf][0], acc[nf][1], r0, r1));
  }
}

// MAIN false (delta): X = dO (map_x), Y = content (map_y), the resident
// small tile q (map_r), the side ring k (map_s); row tiles are query tiles,
// the streamed tiles the keys j <= t.
// MAIN true: X = content, Y = dO, resident k, side ring q (with its log2
// LSEs and deltas); row tiles are key tiles, the streamed tiles the queries
// t >= j.
// The main pass: blockIdx.x = b * NV + head, blockIdx.y = the key tile
// (tile 0, the most query tiles, first; a wave's heads of one batch row
// share its dO tiles in L2). The delta pass: blockIdx.x = (b * NV + head)
// * n + the query tile's place, heaviest first, so that the query tiles
// that read a head's content tiles run in one wave, while L2 holds them.
// Warpgroups 0 and 1 consume alternate streamed tiles (warp w of a
// warpgroup owns rows 16 w .. 16 w + 15 of the row tile), each in its own
// accumulator, and add their delta or dk sums at the end; thread 256
// produces.
template <bool MAIN>
__global__ void __launch_bounds__(kDpThreads, 1)
ctx_bwd_dp_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_y,
                  const __grid_constant__ CUtensorMap map_r,
                  const __grid_constant__ CUtensorMap map_s, const DpArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle's 1024-byte atoms
  unsigned char* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const DpLayout L = dp_layout(a.R, a.stream_x);
  const int S_ = static_cast<int>(L.stages);
  const uint32_t full = base + L.bars, empty = full + 8 * kMaxStages;
  const uint32_t sfull = empty + 8 * kMaxStages, sempty = sfull + 32, rbar = sempty + 32;
  const uint32_t xbar = rbar + 8;
  const int bh = MAIN ? blockIdx.x : blockIdx.x / a.n_tiles, b = bh / a.NV, head = bh % a.NV;
  const int place = blockIdx.x % a.n_tiles;  // the delta pass's
  const int tile = MAIN ? static_cast<int>(blockIdx.y) : a.n_tiles - 1 - place;
  const int u0 = MAIN ? tile : 0, n_u = MAIN ? a.n_tiles - tile : tile + 1;
  const int xh = MAIN ? head : 0, yh = MAIN ? 0 : head;  // dO's map has one head
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    for (int s = 0; s < 4; ++s) {
      mbar_init(sfull + 8 * s, 1);
      mbar_init(sempty + 8 * s, 4);
    }
    mbar_init(rbar, 1);
    for (int c = 0; c < kMaxRes; ++c) mbar_init(xbar + 8 * c, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer
    if (threadIdx.x == 256) {
      const int row0 = 64 * tile;
      if (!a.stream_x)
        for (int c = 0; c < a.R; ++c) {
          mbar_expect_tx(xbar + 8 * c, kBox);
          tma_load_4d(base + c * kBox, &map_x, xbar + 8 * c, 64 * c, xh, row0, b);
        }
      mbar_expect_tx(rbar, kBox);
      tma_load_4d(base + L.rs, &map_r, rbar, 0, head, row0, b);
      for (int ui0 = 0; ui0 < n_u; ui0 += 2) {
        const int nw = ui0 + 1 < n_u ? 2 : 1;  // the pair's tiles
        for (int w = 0; w < nw; ++w) {  // tile ui's side-ring slot ui % 4
          const int ui = ui0 + w, u = u0 + ui, sl = ui & 3;
          const uint32_t slot = base + L.slots + sl * kSlot, sbar = sfull + 8 * sl;
          if (ui >= 4) mbar_wait(sempty + 8 * sl, ((ui >> 2) - 1) & 1);
          mbar_expect_tx(sbar, MAIN ? kBox + 512 : kBox);
          tma_load_4d(slot, &map_s, sbar, 0, head, 64 * u, b);
          if (MAIN) {
            const long long off = static_cast<long long>(bh) * a.s_pad + 64 * u;
            bulk_load(slot + kBox, a.lse2 + off, 256, sbar);
            bulk_load(slot + kBox + 256, a.delta + off, 256, sbar);
          }
        }
        for (int c = 0; c < a.R; ++c)
          for (int w = 0; w < nw; ++w) {
            const int n = dp_stage(ui0 + w, c, a.R, n_u), s = n % S_;
            if (n >= S_) mbar_wait(empty + 8 * s, (n / S_ - 1) & 1);
            const uint32_t st = base + L.ring + s * L.stage, bar = full + 8 * s;
            mbar_expect_tx(bar, L.stage);
            tma_load_4d(st, &map_y, bar, 64 * c, yh, 64 * (u0 + ui0 + w), b);
            if (a.stream_x) tma_load_4d(st + kBox, &map_x, bar, 64 * c, xh, row0, b);
          }
      }
    }
    return;
  }

  // consumers
  const int tid = threadIdx.x & 127, wg = threadIdx.x >> 7, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 64 * tile + 16 * warp;  // the warp's first row
  const int ksteps = (a.DNV + 15) / 16, nj_end = (a.DNV + 15) / 16;
  const long long tab = static_cast<long long>(bh) * a.s_pad;
  mbar_wait(rbar, 0);
  uint32_t ra[4][4];  // the warp's rows of the resident q (delta) or k (main) tile
  box_frags(ra, base + L.rs, 16 * warp, ksteps, lane);
  float lse2r[2] = {0.f, 0.f}, drow[2] = {0.f, 0.f};
  float dk[8][4];
  zero(dk);
  if constexpr (!MAIN) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h;
      lse2r[h] = row < a.S ? a.lse[static_cast<long long>(bh) * a.S + row] * kLog2e : INFINITY;
    }
    // this tile's rows of the dq accumulator
    const int w4 = a.DNV / 4;
    for (int i = threadIdx.x; i < 64 * w4; i += 256) {
      const int row = 64 * tile + i / w4;
      if (row < a.S)
        *reinterpret_cast<float4*>(a.dq_acc +
                                   ((static_cast<long long>(b) * a.S + row) * a.NV + head) * a.DNV +
                                   4 * (i % w4)) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  bf16* dsT = reinterpret_cast<bf16*>(gbase + L.ds + wg * kDs);  // this warpgroup's dS^T

  // no instruction but wgmma defines acc: each tile's first product
  // overwrites it
  float acc[32];
  for (int ui = wg; ui < n_u; ui += 2) {
    const int u = u0 + ui, sl = ui & 3;
    const uint32_t slot = base + L.slots + sl * kSlot;
    mbar_wait(sfull + 8 * sl, (ui >> 2) & 1);
    float sc[8][4];  // S (delta: queries x keys) or S^T (main: keys x queries)
    box_scores<64>(sc, ra, slot, 0, ksteps, lane);
    if constexpr (!MAIN) {
      __syncwarp();
      if (lane == 0) mbar_arrive(sempty + 8 * sl);  // the key tile is read
    }
    for (int c = 0; c < a.R; ++c) {
      const int n = dp_stage(ui, c, a.R, n_u), s = n % S_;
      mbar_wait(full + 8 * s, (n / S_) & 1);
      const uint32_t st = base + L.ring + s * L.stage;
      uint32_t xa = st + kBox;
      if (!a.stream_x) {
        if (ui < 2) mbar_wait(xbar + 8 * c, 0);
        xa = base + c * kBox;
      }
      // k16 steps move 32 bytes inside both boxes' swizzle atoms; 8-row
      // groups lie 1024 bytes apart
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss64(acc, smem_desc(xa + 32 * kk, 16, 1024), smem_desc(st + 32 * kk, 16, 1024),
                   c > 0 || kk > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (c > 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // chunk c - 1 is done
        if (tid == 0) mbar_arrive(empty + 8 * (dp_stage(ui, c - 1, a.R, n_u) % S_));
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (tid == 0) mbar_arrive(empty + 8 * (dp_stage(ui, a.R - 1, a.R, n_u) % S_));

    if constexpr (!MAIN) {
      // alpha, masked where the tile straddles the diagonal or the end
      // (warp-uniform); delta += rowsum(alpha dP)
      const bool edge = 64 * u + 63 > r0 || 64 * u + 64 > a.S;
#pragma unroll
      for (int nf = 0; nf < 8; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + g + 8 * (e >> 1), key = 64 * u + 8 * nf + 2 * t + (e & 1);
          float p = ex2(sc[nf][e] * a.scale_log2 - lse2r[e >> 1]);
          if (edge && (key > row || key >= a.S)) p = 0.f;
          drow[e >> 1] += p * acc[4 * nf + e];
        }
    } else {
      const float* stats = reinterpret_cast<const float*>(gbase + L.slots + sl * kSlot + kBox);
      const bool edge = 64 * u < r0 + 15 || r0 + 16 > a.S;  // warp-uniform
      uint32_t dsa[4][4];  // dS^T (the warp's 16 keys x 64 queries) as A fragments
#pragma unroll
      for (int nf = 0; nf < 8; ++nf) {
        const float2 lv = *reinterpret_cast<const float2*>(stats + 8 * nf + 2 * t);
        const float2 dl = *reinterpret_cast<const float2*>(stats + 64 + 8 * nf + 2 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = r0 + g + 8 * h, qry = 64 * u + 8 * nf + 2 * t + e;
            float p = ex2(sc[nf][2 * h + e] * a.scale_log2 - (e ? lv.y : lv.x));
            if (edge && (key > qry || key >= a.S)) p = 0.f;
            ds[e] = p * (acc[4 * nf + 2 * h + e] - (e ? dl.y : dl.x));
          }
          to_a(dsa, nf, h, ds[0], ds[1]);
        }
      }
      box_mma_ab(dk, dsa, slot, nj_end, lane);  // dk += dS^T q_t
      __syncwarp();
      if (lane == 0) mbar_arrive(sempty + 8 * sl);  // q_t and its rows are read
      // dS^T (keys x queries) for dq_t = dS k_j: the pairs as the A
      // fragments hold them
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          *reinterpret_cast<uint32_t*>(dsT + (16 * warp + g + 8 * (e & 1)) * kDsLd +
                                       (2 * kk + (e >> 1)) * 8 + 2 * t) = dsa[kk][e];
      bar_sync(2 + wg, 128);
      dq_part(a, dsT, base + L.rs, u, warp, b, head, nj_end, lane);
      bar_sync(2 + wg, 128);  // dS^T is read before the next tile writes it
    }
  }

  // warpgroup 1 hands its sums to warpgroup 0 through the dS^T buffers
  float* red = reinterpret_cast<float*>(gbase + L.ds);
  if constexpr (!MAIN) {
#pragma unroll
    for (int h = 0; h < 2; ++h) drow[h] = group_sum(drow[h], 4);
    if (wg == 1 && t == 0) {
      red[16 * warp + g] = drow[0];
      red[16 * warp + g + 8] = drow[1];
    }
    bar_sync(1, 256);
    if (wg == 0 && t == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + g + 8 * h;
        a.delta[tab + row] = row < a.S ? drow[h] + red[16 * warp + g + 8 * h] : 0.f;
        a.lse2[tab + row] = lse2r[h];
      }
  } else {
    bar_sync(1, 256);  // both warpgroups are done with their dS^T
    if (wg == 1)
#pragma unroll
      for (int nf = 0; nf < 8; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[(16 * warp + g + 8 * (e >> 1)) * 64 + 8 * nf + 2 * t + (e & 1)] = dk[nf][e];
    bar_sync(1, 256);
    if (wg == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = r0 + g + 8 * h;
        if (key >= a.S) continue;
        bf16* drow_k = a.dk + ((static_cast<long long>(b) * a.S + key) * a.NV + head) * a.DNV;
        const float* other = red + (16 * warp + g + 8 * h) * 64;
#pragma unroll
        for (int nf = 0; nf < 8; ++nf) {
          const int col = 8 * nf + 2 * t;
          if (col < a.DNV)
            *reinterpret_cast<__nv_bfloat162*>(drow_k + col) =
                __floats2bfloat162_rn((dk[nf][2 * h] + other[col]) * a.scale,
                                      (dk[nf][2 * h + 1] + other[col + 1]) * a.scale);
        }
      }
  }
}

// ------------------------------------------------------------- 2. dcontent

constexpr int kSlab = 192;          // columns of d a CTA takes
constexpr int kDcThreads = 384;     // two consumer warpgroups, one producer
constexpr int kDcStages = 3;
// a stage: the dO slab (three boxes of 64 queries x 64 columns), the query
// tile, at a run's start one or two key tiles, the query tile's log2 LSEs;
// after the ring the exchange area of the two warpgroups' sums, then the
// staging tiles of key tiles hi and lo (three swizzled boxes each) that
// TMA stores into dcontent
constexpr uint32_t kDcQ = kSlab / 64 * kBox, kDcK = kDcQ + kBox, kDcL = kDcK + 2 * kBox;
constexpr uint32_t kDcBytes = kDcK + 256;  // TMA bytes of a stage without key tiles
constexpr int kDcStage = (kDcL + 256 + 1023) / 1024 * 1024;
constexpr int kXld = kSlab / 2 + 8;  // exchange rows (floats): 32 bytes of shift
constexpr uint32_t kDcX = kDcStages * kDcStage, kDcHi = kDcX + 64 * kXld * 4;
constexpr uint32_t kDcLo = kDcHi + kSlab / 64 * kBox, kDcBars = kDcLo + kSlab / 64 * kBox;
constexpr size_t kDcSmem = 1024 + kDcBars + 16 * kDcStages;
static_assert(kDcSmem <= kSmemMax && kDcHi % 1024 == 0, "shared memory");

struct DcArgs {
  const float* lse2;  // (B * NV, s_pad) from the delta pass
  int S, NV, DNV, D, s_pad, n_tiles;
  int hpc;  // sense heads a CTA walks
  float scale_log2;
};

// accumulator n8 chunks [J0, J1) of a warp's 16 keys (rl, rl + 8 within
// the tile), plus the other warpgroup's partial sums in x (from its chunk
// J0 on) where x is given, rounded into the staging tile stg (three
// swizzled boxes of 64 columns; bank-conflict-free)
template <int J0, int J1>
__device__ __forceinline__ void stage_cols(const float (&acc)[kSlab / 2], const float* x,
                                           unsigned char* stg, int rl, int t) {
#pragma unroll
  for (int j = J0; j < J1; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (x != nullptr) {
        const float2 o =
            *reinterpret_cast<const float2*>(x + (rl + 8 * h) * kXld + 8 * (j - J0) + 2 * t);
        v0 += o.x;
        v1 += o.y;
      }
      const int row = rl + 8 * h;
      *reinterpret_cast<uint32_t*>(stg + (j / 8) * kBox + row * 128 + (((j % 8) ^ (row & 7)) << 4) +
                                   4 * t) = pack_bf16x2(v0, v1);
    }
}

// accumulator n8 chunks [J0, J0 + kSlab / 16) of a warp's 16 keys into the
// exchange area x
template <int J0>
__device__ __forceinline__ void stash_half(const float (&acc)[kSlab / 2], float* x, int rl, int t) {
#pragma unroll
  for (int jj = 0; jj < kSlab / 16; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(x + (rl + 8 * h) * kXld + 8 * jj + 2 * t) =
          make_float2(acc[4 * (J0 + jj) + 2 * h], acc[4 * (J0 + jj) + 2 * h + 1]);
}

// the staging tile at stg into dcontent rows [64 kt, 64 kt + 64) of head
// `head`, columns [d0, min(d0 + 192, D)): a TMA store a box, one bulk group
// (the map clips rows past S and columns past D)
__device__ __forceinline__ void store_tile(const CUtensorMap* map_dc, uint32_t stg, int d0, int D,
                                           int head, int kt, int b) {
#pragma unroll
  for (int j = 0; j < kSlab / 64; ++j)
    if (d0 + 64 * j < D) tma_store_4d(map_dc, stg + j * kBox, d0 + 64 * j, head, 64 * kt, b);
  bulk_commit();
}

// The producer's run: query tiles [u0, u1) of the slab from d0; the run's
// first stage also brings nk key tiles (kt0, then kt1).
__device__ __forceinline__ void dc_produce(const CUtensorMap* map_g, const CUtensorMap* map_q,
                                           const CUtensorMap* map_k, const DcArgs& a, int& n,
                                           uint32_t base, uint32_t full, uint32_t empty, int d0,
                                           int b, int head, int u0, int u1, int nk, int kt0,
                                           int kt1) {
  const float* ls = a.lse2 + (static_cast<long long>(b) * a.NV + head) * a.s_pad;
  for (int u = u0; u < u1; ++u, ++n) {
    const int s = n % kDcStages;
    if (n >= kDcStages) mbar_wait(empty + 8 * s, (n / kDcStages - 1) & 1);
    const uint32_t st = base + s * kDcStage, bar = full + 8 * s;
    mbar_expect_tx(bar, kDcBytes + (u == u0 ? nk * kBox : 0));
#pragma unroll
    for (int j = 0; j < kSlab / 64; ++j)
      tma_load_4d(st + j * kBox, map_g, bar, d0 + 64 * j, 0, 64 * u, b);
    tma_load_4d(st + kDcQ, map_q, bar, 0, head, 64 * u, b);
    bulk_load(st + kDcL, ls + 64 * u, 256, bar);
    if (u == u0)
      for (int j = 0; j < nk; ++j)
        tma_load_4d(st + kDcK + j * kBox, map_k, bar, 0, head, 64 * (j == 0 ? kt0 : kt1), b);
  }
}

// A consumer warpgroup's run, in dc_produce's order (n counts the ring's
// stages): each stage adds alpha^T (the warp's 16 keys from r0 x KW queries
// from wq of the query tile) @ dO[those queries, the slab] into acc. kslot:
// the key-tile slot of the run's first stage. fresh: the run's first
// product overwrites acc. No instruction but wgmma defines acc between a
// fresh run's first product and the run's last wait.
template <int KW>
__device__ __forceinline__ void dc_consume(float (&acc)[kSlab / 2], const DcArgs& a, int& n,
                                           uint32_t base, const unsigned char* gbase,
                                           uint32_t full, uint32_t empty, int r0, int kslot,
                                           int wq, int u0, int u1, bool fresh) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ksteps = (a.DNV + 15) / 16, n_st = u1 - u0;
  uint32_t ka[4][4], pa[2][KW / 16][4];
  for (int i = 0; i < n_st; i += 2) {
#pragma unroll
    // alpha buffer v: the last stage's products may still read the other
    for (int v = 0; v < 2; ++v) {
      if (i + v < n_st) {
        const int u = u0 + i + v, s = n % kDcStages;
        mbar_wait(full + 8 * s, (n / kDcStages) & 1);
        const uint32_t st = base + s * kDcStage;
        if (u == u0) box_frags(ka, st + kDcK + kslot * kBox, 16 * warp, ksteps, lane);
        const int q0 = 64 * u + wq;  // the warpgroup's first query
        if (q0 + KW - 1 < r0) {      // every query before the warp's keys
#pragma unroll
          for (int kk = 0; kk < KW / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) pa[v][kk][e] = 0u;
        } else {
          float c[KW / 8][4];
          box_scores<KW>(c, ka, st + kDcQ, wq, ksteps, lane);
          // alpha^T = 2^(s * scale * log2 e - lse2[query]), masked where the
          // stage straddles the diagonal (warp-uniform); queries past S have
          // lse2 = +inf
          const float* ls = reinterpret_cast<const float*>(gbase + s * kDcStage + kDcL) + wq;
          const bool edge = q0 < r0 + 15;
#pragma unroll
          for (int nf = 0; nf < KW / 8; ++nf) {
            const float2 lv = *reinterpret_cast<const float2*>(ls + 8 * nf + 2 * t);
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = r0 + g + 8 * (e >> 1), qry = q0 + 8 * nf + 2 * t + (e & 1);
              p[e] = ex2(c[nf][e] * a.scale_log2 - ((e & 1) ? lv.y : lv.x));
              if (edge && qry < key) p[e] = 0.f;
            }
            pa[v][nf >> 1][(nf & 1) * 2] = pack_bf16x2(p[0], p[1]);
            pa[v][nf >> 1][(nf & 1) * 2 + 1] = pack_bf16x2(p[2], p[3]);
          }
        }
        // acc += alpha^T (64 x KW) @ dO[the warpgroup's queries, the slab]:
        // k16 steps move 16 rows (2048 bytes) down the boxes, which lie
        // kBox apart (leading offset), 8-row groups 1024 bytes apart
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < KW / 16; ++kk)
          wgmma_ra192(acc, pa[v][kk], smem_desc(st + (wq + 16 * kk) * 128, kBox, 1024),
                      !fresh || i + v > 0 || kk > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // stage n - 1 is done
        fence_regs(pa[v ^ 1]);
        if (i + v > 0 && tid == 0) mbar_arrive(empty + 8 * ((n - 1) % kDcStages));
        ++n;
      }
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  fence_regs(pa[0]);
  fence_regs(pa[1]);
  if (n_st > 0 && tid == 0) mbar_arrive(empty + 8 * ((n - 1) % kDcStages));
}

// A CTA owns the key tiles hi = n - 1 - y and lo = y (one where they meet)
// of hpc sense heads (group x % G of G = ceil(NV / hpc)) of batch row x / G,
// and the column slab z. For each head in turn: first the query tiles [hi,
// n), warpgroup 0 on key tile hi (which it then stores) and 1 on tile lo;
// then [lo, hi), both on tile lo, warpgroup w taking queries [32 w, 32 w +
// 32) of each stage; at the end the two add their sums for tile lo through
// the exchange area, half the columns at a time. The producer runs ahead
// across the heads. Every CTA that owns two tiles does n + 1 tiles of 64 x
// 64 products a head.
__global__ void __launch_bounds__(kDcThreads, 1)
ctx_bwd_dc_kernel(const __grid_constant__ CUtensorMap map_g,
                  const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_dc, const DcArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full = base + kDcBars, empty = full + 8 * kDcStages;
  const int n_groups = (a.NV + a.hpc - 1) / a.hpc;
  const int b = blockIdx.x / n_groups, h0 = (blockIdx.x % n_groups) * a.hpc;
  const int h1 = min(a.NV, h0 + a.hpc);
  const int hi = a.n_tiles - 1 - static_cast<int>(blockIdx.y), lo = blockIdx.y;
  const int d0 = blockIdx.z * kSlab, wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDcStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int n = 0;
      for (int head = h0; head < h1; ++head) {
        if (hi != lo)
          dc_produce(&map_g, &map_q, &map_k, a, n, base, full, empty, d0, b, head, hi,
                     a.n_tiles, 2, hi, lo);
        dc_produce(&map_g, &map_q, &map_k, a, n, base, full, empty, d0, b, head, lo,
                   hi != lo ? hi : a.n_tiles, 1, lo, lo);
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int tid = threadIdx.x & 127;
    float acc[kSlab / 2];
    float* x = reinterpret_cast<float*>(gbase + kDcX);
    unsigned char* const stg_hi = gbase + kDcHi;
    unsigned char* const stg_lo = gbase + kDcLo;
    const int rl = 16 * warp + g;
    int n = 0;  // stages consumed
    // dcontent leaves through the staging tiles by TMA: warpgroup 0's first
    // thread stores tile hi, warpgroup 1's tile lo, and each waits for its
    // last store to have read its tile before the tile is written again
    for (int head = h0; head < h1; ++head) {
      if (hi != lo) {
        const int r0 = 64 * (wg == 0 ? hi : lo) + 16 * warp;
        dc_consume<64>(acc, a, n, base, gbase, full, empty, r0, wg, 0, hi, a.n_tiles, true);
        if (wg == 0) {
          if (tid == 0) bulk_wait_read();
          bar_sync(2, 128);
          stage_cols<0, kSlab / 8>(acc, nullptr, stg_hi, rl, t);
          fence_proxy_async();
          bar_sync(2, 128);
          if (tid == 0) store_tile(&map_dc, base + kDcHi, d0, a.D, head, hi, b);
        }
      }
      dc_consume<32>(acc, a, n, base, gbase, full, empty, 64 * lo + 16 * warp, 0, 32 * wg, lo,
                     hi != lo ? hi : a.n_tiles, wg == 0 || hi == lo);
      // tile lo: warpgroup 0 adds 1's sums into the slab's first 96 columns,
      // then 1 adds 0's into the rest; each thread reads and writes only its
      // own positions of x, so two barriers a head order the hand-overs
      if (wg == 1) {
        if (tid == 0) bulk_wait_read();
        stash_half<0>(acc, x, rl, t);
      }
      bar_sync(1, 256);
      if (wg == 0) {
        stage_cols<0, kSlab / 16>(acc, x, stg_lo, rl, t);
        stash_half<kSlab / 16>(acc, x, rl, t);
        fence_proxy_async();
      }
      bar_sync(1, 256);
      if (wg == 1) {
        stage_cols<kSlab / 16, kSlab / 8>(acc, x, stg_lo, rl, t);
        fence_proxy_async();
        bar_sync(3, 128);
        if (tid == 0) store_tile(&map_dc, base + kDcLo, d0, a.D, head, lo, b);
      }
    }
    if (tid == 0) bulk_wait_read();  // the tiles outlive their last stores' reads
  }
}

// ------------------------------------------------------------- 4. dq

// dq = accumulator * scale, four elements a thread and step
__global__ void __launch_bounds__(256)
ctx_bwd_convert_kernel(const float4* __restrict__ acc, uint2* __restrict__ dq, long long n4,
                       float scale) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float4 v = acc[i];
    dq[i] = make_uint2(pack_bf16x2(v.x * scale, v.y * scale),
                       pack_bf16x2(v.z * scale, v.w * scale));
  }
}

bool aligned16(const void* p, long long sb, long long st, long long sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 && st % 8 == 0 && sh % 8 == 0;
}

cudaError_t launch_tc(const void* q, const void* k, const void* content, const void* g,
                      const float* lse, float* lse2, float* delta, float* dq_acc, bf16* dq,
                      bf16* dk, bf16* dc, int B, int S, int NV, int DNV, int D, long long q_sb,
                      long long q_st, long long q_sh, long long k_sb, long long k_st,
                      long long k_sh, long long c_sb, long long c_st, long long c_sh,
                      long long g_sb, long long g_st, int s_pad, int hpc, float scale,
                      cudaStream_t stream) {
  if (s_pad < S || s_pad % 64 || DNV > 64 || DNV % 8 || D % 8 || hpc < 1 ||
      !aligned16(q, q_sb, q_st, q_sh) || !aligned16(k, k_sb, k_st, k_sh) ||
      !aligned16(content, c_sb, c_st, c_sh) || !aligned16(g, g_sb, g_st, 8))
    return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mc, mg, mdc;
  cudaError_t err = view_map(&mq, q, DNV, NV, S, B, q_sh, q_st, q_sb);
  if (err == cudaSuccess) err = view_map(&mk, k, DNV, NV, S, B, k_sh, k_st, k_sb);
  if (err == cudaSuccess) err = view_map(&mc, content, D, NV, S, B, c_sh, c_st, c_sb);
  if (err == cudaSuccess) err = view_map(&mg, g, D, 1, S, B, D, g_st, g_sb);
  if (err == cudaSuccess)
    err = view_map(&mdc, dc, D, NV, S, B, D, static_cast<long long>(NV) * D,
                   static_cast<long long>(S) * NV * D);
  if (err == cudaSuccess) err = allow_smem<ctx_bwd_dp_kernel<false>>(kSmemMax);
  if (err == cudaSuccess) err = allow_smem<ctx_bwd_dp_kernel<true>>(kSmemMax);
  if (err == cudaSuccess) err = allow_smem<ctx_bwd_dc_kernel>(kDcSmem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (S + 63) / 64, R = (D + 63) / 64;
  const bool stream_x = R > kMaxRes;
  const float scale_log2 = scale * kLog2e;
  const DpArgs a{lse, lse2, delta, dq_acc, dk, S, NV, DNV, s_pad, n_tiles, R, stream_x ? 1 : 0,
                 scale, scale_log2};
  const size_t dp_smem = dp_layout(R, stream_x).bytes;
  const dim3 grid(static_cast<unsigned>(B * NV), static_cast<unsigned>(n_tiles));
  ctx_bwd_dp_kernel<false><<<grid.x * grid.y, kDpThreads, dp_smem, stream>>>(mg, mc, mq, mk, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const DcArgs c{lse2, S, NV, DNV, D, s_pad, n_tiles, hpc, scale_log2};
  const dim3 dc_grid(static_cast<unsigned>(B * ((NV + hpc - 1) / hpc)),
                     static_cast<unsigned>((n_tiles + 1) / 2),
                     static_cast<unsigned>((D + kSlab - 1) / kSlab));
  ctx_bwd_dc_kernel<<<dc_grid, kDcThreads, kDcSmem, stream>>>(mg, mq, mk, mdc, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ctx_bwd_dp_kernel<true><<<grid, kDpThreads, dp_smem, stream>>>(mc, mg, mk, mq, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n4 = static_cast<long long>(B) * S * NV * DNV / 4;
  const unsigned blocks = static_cast<unsigned>(std::min<long long>((n4 + 255) / 256, 4096));
  if (n4 > 0)
    ctx_bwd_convert_kernel<<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(dq_acc),
                                                      reinterpret_cast<uint2*>(dq), n4, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------- f32 (SIMT)

constexpr int ST = 32, CH = 64, FLD = CH + 1, FSLAB = 128, kSimtThreads = 256;

// rows [r0, r0 + 32) x columns [c0, c0 + W) of a row-strided f32 matrix
// into dst (leading dimension ld); zero past S rows or past `cols` columns
template <int W>
__device__ __forceinline__ void load_f32(float* dst, int ld, const float* base, long long st,
                                         int r0, int S, int c0, int cols) {
  for (int idx = threadIdx.x; idx < ST * W; idx += kSimtThreads) {
    const int rr = idx / W, cc = idx % W;
    dst[rr * ld + cc] = (r0 + rr < S && c0 + cc < cols) ? base[(r0 + rr) * st + c0 + cc] : 0.f;
  }
}

// acc[i] += x[r] . y[c + 8 i] over the first w columns of two FLD-wide tiles
__device__ __forceinline__ void dots4(float (&acc)[4], const float (*x)[FLD],
                                      const float (*y)[FLD], int r, int c, int w) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float a = 0.f;
    for (int cc = 0; cc < w; ++cc) a += x[r][cc] * y[c + 8 * i][cc];
    acc[i] += a;
  }
}

// dp[i] += X[x0 + r] . Y[y0 + c + 8 i] over the whole d, both streamed
// through 64-column chunks in shared memory
__device__ __forceinline__ void dp_f32(float (&dp)[4], float (*xs)[FLD], float (*ys)[FLD],
                                       const float* xb, long long x_st, int x0, const float* yb,
                                       long long y_st, int y0, int S, int D, int r, int c) {
  for (int d0 = 0; d0 < D; d0 += CH) {
    __syncthreads();
    load_f32<CH>(&xs[0][0], FLD, xb, x_st, x0, S, d0, D);
    load_f32<CH>(&ys[0][0], FLD, yb, y_st, y0, S, d0, D);
    __syncthreads();
    dots4(dp, xs, ys, r, c, CH);
  }
}

// one block per (32-query tile, head, batch row); thread (r, c) = query
// q0 + r, keys c + 8 i of each tile, dq columns c + 8 j
__global__ void __launch_bounds__(kSimtThreads)
dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ c, const float* __restrict__ g_out,
               const float* __restrict__ lse, float* __restrict__ delta, float* __restrict__ dq,
               int S, int NV, int DNV, int D, Strides sq, Strides sk, Strides sc, long long g_sb,
               long long g_st, float scale) {
  __shared__ float Qs[ST][FLD], Ks[ST][FLD], Gs[ST][FLD], Cs[ST][FLD];
  __shared__ float DSs[ST][ST + 1];
  const int q0 = blockIdx.x * ST, head = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 3, cl = threadIdx.x & 7, row = q0 + r;
  const long long bh = static_cast<long long>(b) * NV + head;
  const float* kb = k + b * sk.sb + head * sk.sh;
  const float* cb = c + b * sc.sb + head * sc.sh;
  const float* gb = g_out + b * g_sb;
  load_f32<CH>(&Qs[0][0], FLD, q + b * sq.sb + head * sq.sh, sq.st, q0, S, 0, DNV);
  const float row_lse = row < S ? lse[bh * S + row] : 0.f;
  float row_delta = 0.f, dq_acc[CH / 8];
#pragma unroll
  for (int j = 0; j < CH / 8; ++j) dq_acc[j] = 0.f;

  const int kv_end = min(S, q0 + ST);
  for (int pass = 0; pass < 2; ++pass) {
    float part = 0.f;
    for (int j0 = 0; j0 < kv_end; j0 += ST) {
      __syncthreads();
      load_f32<CH>(&Ks[0][0], FLD, kb, sk.st, j0, S, 0, DNV);
      float dp[4] = {0.f, 0.f, 0.f, 0.f}, s[4] = {0.f, 0.f, 0.f, 0.f};
      dp_f32(dp, Gs, Cs, gb, g_st, q0, cb, sc.st, j0, S, D, r, cl);  // syncs: Ks ready
      dots4(s, Qs, Ks, r, cl, DNV);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kl = cl + 8 * i, key = j0 + kl;
        const bool valid = row < S && key < S && key <= row;
        const float a = valid ? expf(s[i] * scale - row_lse) : 0.f;
        if (pass == 0)
          part += a * dp[i];
        else
          DSs[r][kl] = a * (dp[i] - row_delta);
      }
      if (pass == 1) {
        __syncwarp();  // the row's eight threads share one warp
        for (int kl = 0; kl < ST; ++kl) {
          const float ds = DSs[r][kl];
#pragma unroll
          for (int j = 0; j < CH / 8; ++j) dq_acc[j] += ds * Ks[kl][cl + 8 * j];
        }
      }
    }
    if (pass == 0) {
      row_delta = group_sum(part, 8);
      if (cl == 0 && row < S) delta[bh * S + row] = row_delta;
    }
  }
  if (row >= S) return;
  float* drow = dq + ((static_cast<long long>(b) * S + row) * NV + head) * DNV;
#pragma unroll
  for (int j = 0; j < CH / 8; ++j)
    if (cl + 8 * j < DNV) drow[cl + 8 * j] = dq_acc[j] * scale;
}

// one block per (32-key tile, head, batch row); thread (r, c) = key k0 + r,
// queries c + 8 i of each tile, dk columns c + 8 j
__global__ void __launch_bounds__(kSimtThreads)
dk_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ c, const float* __restrict__ g_out,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, int S, int NV, int DNV, int D, Strides sq, Strides sk,
               Strides sc, long long g_sb, long long g_st, float scale) {
  __shared__ float Ks[ST][FLD], Qs[ST][FLD], Cs[ST][FLD], Gs[ST][FLD];
  __shared__ float DSs[ST][ST + 1], Ls[ST], Dl[ST];
  const int k0 = blockIdx.x * ST, head = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 3, cl = threadIdx.x & 7, key = k0 + r;
  const long long bh = static_cast<long long>(b) * NV + head;
  const float* qb = q + b * sq.sb + head * sq.sh;
  const float* cb = c + b * sc.sb + head * sc.sh;
  const float* gb = g_out + b * g_sb;
  load_f32<CH>(&Ks[0][0], FLD, k + b * sk.sb + head * sk.sh, sk.st, k0, S, 0, DNV);
  float dk_acc[CH / 8];
#pragma unroll
  for (int j = 0; j < CH / 8; ++j) dk_acc[j] = 0.f;

  for (int q0 = k0; q0 < S; q0 += ST) {
    __syncthreads();
    load_f32<CH>(&Qs[0][0], FLD, qb, sq.st, q0, S, 0, DNV);
    for (int i = threadIdx.x; i < ST; i += kSimtThreads) {
      const bool in = q0 + i < S;
      Ls[i] = in ? lse[bh * S + q0 + i] : 0.f;
      Dl[i] = in ? delta[bh * S + q0 + i] : 0.f;
    }
    float dp[4] = {0.f, 0.f, 0.f, 0.f}, s[4] = {0.f, 0.f, 0.f, 0.f};
    dp_f32(dp, Cs, Gs, cb, sc.st, k0, gb, g_st, q0, S, D, r, cl);  // syncs: Qs ready
    dots4(s, Ks, Qs, r, cl, DNV);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ql = cl + 8 * i, qry = q0 + ql;
      const bool valid = key < S && qry < S && key <= qry;
      const float a = valid ? expf(s[i] * scale - Ls[ql]) : 0.f;
      DSs[r][ql] = a * (dp[i] - Dl[ql]);
    }
    __syncwarp();
    for (int ql = 0; ql < ST; ++ql) {
      const float ds = DSs[r][ql];
#pragma unroll
      for (int j = 0; j < CH / 8; ++j) dk_acc[j] += ds * Qs[ql][cl + 8 * j];
    }
  }
  if (key >= S) return;
  float* drow = dk + ((static_cast<long long>(b) * S + key) * NV + head) * DNV;
#pragma unroll
  for (int j = 0; j < CH / 8; ++j)
    if (cl + 8 * j < DNV) drow[cl + 8 * j] = dk_acc[j] * scale;
}

// one block per (32-key tile, 128-column slab of d, head, batch row);
// thread (r, c) = key k0 + r, queries c + 8 i, slab columns c + 8 j
__global__ void __launch_bounds__(kSimtThreads)
dc_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ g_out, const float* __restrict__ lse,
               float* __restrict__ dc, int S, int NV, int DNV, int D, int n_slabs, Strides sq,
               Strides sk, long long g_sb, long long g_st, float scale) {
  __shared__ float Ks[ST][FLD], Qs[ST][FLD], Gs[ST][FSLAB + 1];
  __shared__ float Ps[ST][ST + 1], Ls[ST];
  const int k0 = blockIdx.x * ST, head = blockIdx.y / n_slabs, b = blockIdx.z;
  const int d0 = (blockIdx.y % n_slabs) * FSLAB;
  const int r = threadIdx.x >> 3, cl = threadIdx.x & 7, key = k0 + r;
  const long long bh = static_cast<long long>(b) * NV + head;
  const float* qb = q + b * sq.sb + head * sq.sh;
  const float* gb = g_out + b * g_sb;
  load_f32<CH>(&Ks[0][0], FLD, k + b * sk.sb + head * sk.sh, sk.st, k0, S, 0, DNV);
  float dc_acc[FSLAB / 8];
#pragma unroll
  for (int j = 0; j < FSLAB / 8; ++j) dc_acc[j] = 0.f;

  for (int q0 = k0; q0 < S; q0 += ST) {
    __syncthreads();
    load_f32<CH>(&Qs[0][0], FLD, qb, sq.st, q0, S, 0, DNV);
    load_f32<FSLAB>(&Gs[0][0], FSLAB + 1, gb, g_st, q0, S, d0, D);
    for (int i = threadIdx.x; i < ST; i += kSimtThreads)
      Ls[i] = q0 + i < S ? lse[bh * S + q0 + i] : 0.f;
    __syncthreads();
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    dots4(s, Ks, Qs, r, cl, DNV);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ql = cl + 8 * i, qry = q0 + ql;
      const bool valid = key < S && qry < S && key <= qry;
      Ps[r][ql] = valid ? expf(s[i] * scale - Ls[ql]) : 0.f;
    }
    __syncwarp();
    for (int ql = 0; ql < ST; ++ql) {
      const float a = Ps[r][ql];
#pragma unroll
      for (int j = 0; j < FSLAB / 8; ++j) dc_acc[j] += a * Gs[ql][cl + 8 * j];
    }
  }
  if (key >= S) return;
  float* drow = dc + ((static_cast<long long>(b) * S + key) * NV + head) * D + d0;
#pragma unroll
  for (int j = 0; j < FSLAB / 8; ++j)
    if (d0 + cl + 8 * j < D) drow[cl + 8 * j] = dc_acc[j];
}

}  // namespace

// q, k: (B, S, NV, DNV), content (B, S, NV, D) and g (B, S, D), all bf16 or
// all f32 (dtype), with the given strides (rows 16-byte aligned); lse (B,
// NV, S) f32 from the forward. Workspaces the wrapper allocates: lse2 and
// delta (B * NV * s_pad f32, s_pad a multiple of 64 at least S; f32 uses
// delta only, as (B, NV, S)) and, for bf16, the dq accumulator (B * S * NV
// * DNV f32); heads_per_cta: the sense heads a CTA of the bf16 dcontent
// pass walks (ops/backpack_kernels._k6_heads). dq, dk (B, S, NV, DNV) and
// dc (B, S, NV, D): contiguous
// outputs of the operands' dtype. Returns a CUDA error code (a tensor map
// that does not encode gives cudaErrorInvalidValue).
extern "C" int fused_contextualization_bwd_launch(
    const void* q, const void* k, const void* content, const void* g, const void* lse,
    void* lse2, void* delta, void* dq_acc, void* dq, void* dk, void* dc, long long B,
    long long S, long long NV, long long DNV, long long D, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh, long long c_sb,
    long long c_st, long long c_sh, long long g_sb, long long g_st, long long s_pad,
    long long heads_per_cta, float scale, long long dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sq{q_sb, q_st, q_sh}, sk{k_sb, k_st, k_sh}, sc{c_sb, c_st, c_sh};
  const auto* lp = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  const int s = static_cast<int>(S), nv = static_cast<int>(NV), dnv = static_cast<int>(DNV),
            d = static_cast<int>(D);
  if (dtype == DT_BF16)
    return static_cast<int>(launch_tc(
        q, k, content, g, lp, static_cast<float*>(lse2), dl, static_cast<float*>(dq_acc),
        static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dc),
        static_cast<int>(B), s, nv, dnv, d, q_sb, q_st, q_sh, k_sb, k_st, k_sh, c_sb, c_st, c_sh,
        g_sb, g_st, static_cast<int>(s_pad), static_cast<int>(heads_per_cta), scale, st));
  if (dtype != DT_F32) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* cp = static_cast<const float*>(content);
  const auto* gp = static_cast<const float*>(g);
  const unsigned tiles = static_cast<unsigned>((S + ST - 1) / ST);
  const dim3 grid(tiles, static_cast<unsigned>(NV), static_cast<unsigned>(B));
  dq_simt_kernel<<<grid, kSimtThreads, 0, st>>>(qp, kp, cp, gp, lp, dl, static_cast<float*>(dq),
                                                s, nv, dnv, d, sq, sk, sc, g_sb, g_st, scale);
  dk_simt_kernel<<<grid, kSimtThreads, 0, st>>>(qp, kp, cp, gp, lp, dl, static_cast<float*>(dk),
                                                s, nv, dnv, d, sq, sk, sc, g_sb, g_st, scale);
  const int n_slabs = static_cast<int>((D + FSLAB - 1) / FSLAB);
  const dim3 dc_grid(tiles, static_cast<unsigned>(NV * n_slabs), static_cast<unsigned>(B));
  dc_simt_kernel<<<dc_grid, kSimtThreads, 0, st>>>(qp, kp, gp, lp, static_cast<float*>(dc), s, nv,
                                                   dnv, d, n_slabs, sq, sk, g_sb, g_st, scale);
  return static_cast<int>(cudaGetLastError());
}
