// K4: fused Backpack contextualization (forward), and the forward of K6.
//
// Replaces the TPU kernels backpacks_flash_attn_tpu/ops/backpack_kernels.py
// _fused_ctx_infer (:281, Pallas body _fused_ctx_infer_kernel :119) and
// _fused_ctx_fwd_lse (:309, body _fused_ctx_fwd_lse_kernel :137):
//   out[b,t,:] = sum_k sum_{j<=t} softmax_j(scale * q[b,t,k] . k[b,j,k]) content[b,j,k,:]
// with alpha (b, nv, s, s) never stored, and each (row, head)'s natural-log
// log-sum-exp in `lse` (b, nv, s), which K6 (fused_contextualization_bwd.cu)
// reads.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): bytes. Per (query, key)
// pair and sense head it does dnv (48) multiply-adds for the score and d
// (768) for the value sum. At (8, 512, nv 16, dnv 48, d 768) that is 27.4
// GFLOP (0.0277 ms) against 0.12 GB of q, k, content and out (0.0357 ms);
// at (32, 512) 0.111 ms against 0.1427 ms.
//
// bf16 design (two launches from one C entry):
// 1. ctx_lse_kernel: each (64-row query tile, head, batch row) block runs
//    an online softmax over its causal keys (mma.sync scores, f32, key
//    tiles through a 3-stage cp.async ring; heavy tiles first, eight blocks
//    an SM) and writes each row's LSE twice:
//    in natural-log units to `lse`, and in log2 units to a workspace (b * nv,
//    s_pad) whose rows past s hold +inf, so their probabilities come out 0.
// 2. ctx_wgmma_kernel<ROWS>: exactly normalized probabilities into one f32
//    accumulator across all heads (every head's probabilities are final
//    before the product: no rescaling, no atomics, a deterministic sum). A
//    block owns a pair of query-row tiles, n - 1 - i and i, so that every
//    block does the same products, and a slab of 192 columns of d: the
//    48-wide scores are recomputed once per slab, 4 times at d 768.
//    Warpgroup 2's first thread keeps a 4-stage ring full by TMA on
//    full/empty mbarriers: per stage the content slab (three boxes of 64
//    keys x 64 columns, 128-byte swizzle, through a 4-D map over the content
//    view's (d, nv, s, b) strides: keys past s and columns past d arrive as
//    zeros) and the key tile (dnv columns padded to 64 by the map); with a
//    head's first key tile also the query rows and their LSEs. Warpgroups 0
//    and 1 consume: each warp computes its 16 rows' scores on mma.sync from
//    its query fragments, forms p = 2^(s * scale * log2 e - lse2) (masked
//    only where the stage straddles the diagonal or the end), packs p to
//    bf16 in the register layout of wgmma's A operand and issues wgmma
//    m64n192k16 with B = the content tile (N-major, the transpose bit set).
//    P is double-buffered: a stage's scores run while the last stage's
//    products are in flight.
//    What bounds it (probe_k4.py, H100): the loads first. With no scores
//    and no products the ring alone took 72-79% of the kernel's time, and
//    the products and scores alone 87-90%; so the schedule is shaped to
//    read less: ROWS 64 (the forward's 8 x 512: 128 blocks) reads each
//    content tile once a block: over the key tiles that both of its row
//    tiles see, warpgroup 0 multiplies tile hi's rows and 1 tile lo's (one
//    read serves 128 rows); over the rest both take tile hi, 32 keys of
//    each stage apiece, and add their sums through shared memory at the
//    end. ROWS 128 (32 x 512) runs a 128-row tile at a time, a warpgroup a
//    64-row half. ops/backpack_kernels._k4_rows picks ROWS. Slabs of 256
//    columns (3 score passes at d 768, 3 stages) and warpgroups taking turns
//    to issue ran slower; the exponentials are 5% of the kernel.
//    Needs 16-byte aligned q/k/content rows and dnv % 8 == 0.
//
// f32 operands, and bf16 operands that are not aligned so, take the SIMT
// kernel below: one block per (32-row query tile, 128-column slice of d,
// batch row), an online softmax per head with the f32 output slice in
// registers, recomputing the scores once per slice; the blocks of the first
// slice write the LSE.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int DNVP = 64, KLD = DNVP + 8;  // padded key row (16-byte aligned, conflict-free)

// A fragments of the 16 query rows starting at r0 for every 16-wide step of
// dnv (rows past S and columns past DNV are zero): a[ks] = {(g, 2t), (g + 8,
// 2t), (g, 2t + 8), (g + 8, 2t + 8)} pairs.
__device__ __forceinline__ void load_q_frags(uint32_t (&a)[DNVP / 16][4], const bf16* qb,
                                             long long q_st, int r0, int S, int DNV, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < DNVP / 16; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + 8 * (e & 1), col = ks * 16 + 2 * t + 8 * (e >> 1);
      a[ks][e] = (row < S && col < DNV) ? ld32(qb + row * q_st + col) : 0u;
    }
}

// ------------------------------------------------------------- 1. row LSE

constexpr int LQ = 64, LK = 64, kLseThreads = 128, kLseBuf = 3;

__global__ void __launch_bounds__(kLseThreads, 8)
ctx_lse_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, float* __restrict__ lse,
               float* __restrict__ ws, int S, int NV, int DNV, int s_pad, long long q_sb,
               long long q_st, long long q_sh, long long k_sb, long long k_st, long long k_sh,
               float scale_log2) {
  __shared__ __align__(16) bf16 Ks[kLseBuf][LK][KLD];
  const int q0 = (gridDim.x - 1 - blockIdx.x) * LQ;  // heavy (late) tiles first
  const int head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16;
  const int ksteps = (DNV + 15) / 16;
  const bf16* kb = k + b * k_sb + head * k_sh;

  uint32_t qa[DNVP / 16][4];
  load_q_frags(qa, q + b * q_sb + head * q_sh, q_st, r0, S, DNV, g, t);
  float m[2] = {FLASH_NEG_INF, FLASH_NEG_INF}, l[2] = {0.f, 0.f};
  // key columns [DNV, DNVP) stay zero; the rest arrive as 16-byte chunks
  // (DNV % 8 == 0)
  const int chunks = DNV / 8;
  for (int idx = tid; idx < kLseBuf * LK * (DNVP / 8); idx += kLseThreads)
    if (idx % (DNVP / 8) >= chunks)
      *reinterpret_cast<uint4*>(&Ks[idx / (LK * DNVP / 8)][(idx / (DNVP / 8)) % LK][idx % (DNVP / 8) * 8]) =
          make_uint4(0u, 0u, 0u, 0u);
  // key tile j into buffer j % kLseBuf: cp.async, zeros past S; chunk idx =
  // tid + i kLseThreads is row idx / chunks, chunk idx % chunks, stepped
  // without a division
  const int step_r = kLseThreads / chunks, step_c = kLseThreads % chunks;
  auto load = [&](int j) {
    int rr = tid / chunks, cc = tid % chunks;
    for (int idx = tid; idx < LK * chunks; idx += kLseThreads) {
      bf16* dst = &Ks[j % kLseBuf][rr][cc * 8];
      if (j * LK + rr < S)
        cp_async16(dst, kb + (j * LK + rr) * k_st + cc * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      rr += step_r;
      cc += step_c;
      if (cc >= chunks) {
        cc -= chunks;
        ++rr;
      }
    }
  };
  // padding tiles past S only write their +inf rows
  const int n_kt = q0 < S ? (min(S, q0 + LQ) + LK - 1) / LK : 0;
#pragma unroll
  for (int j = 0; j < kLseBuf - 1; ++j) {
    if (j < n_kt) load(j);
    cp_async_commit();
  }
  for (int j = 0; j < n_kt; ++j) {
    if (j + kLseBuf - 1 < n_kt) load(j + kLseBuf - 1);  // its buffer was freed by the last barrier
    cp_async_commit();
    cp_async_wait<kLseBuf - 1>();  // tile j has landed
    __syncthreads();
    float c[LK / 8][4];
    zero(c);
#pragma unroll
    for (int ks = 0; ks < DNVP / 16; ++ks) {
      if (ks >= ksteps) break;
#pragma unroll
      for (int nf = 0; nf < LK / 8; ++nf) {
        const uint32_t bfr[2] = {ld32(&Ks[j % kLseBuf][nf * 8 + g][ks * 16 + 2 * t]),
                                 ld32(&Ks[j % kLseBuf][nf * 8 + g][ks * 16 + 2 * t + 8])};
        mma_16816(c[nf], qa[ks], bfr);
      }
    }
    // online softmax in log2 units, as ctx_wgmma_kernel forms p; masks only
    // where the tile straddles the warp's diagonal or the end (the pass is
    // bound by its instructions)
    const bool edge = (j + 1) * LK - 1 > r0 || (j + 1) * LK > S;  // warp-uniform
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h;
      float tmax = FLASH_NEG_INF, sum = 0.f;
      if (edge) {
#pragma unroll
        for (int nf = 0; nf < LK / 8; ++nf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = j * LK + nf * 8 + 2 * t + e;
            float& v = c[nf][2 * h + e];
            v = (key < S && key <= row) ? v * scale_log2 : FLASH_NEG_INF;
            tmax = fmaxf(tmax, v);
          }
      } else {
#pragma unroll
        for (int nf = 0; nf < LK / 8; ++nf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = c[nf][2 * h + e];
            v *= scale_log2;
            tmax = fmaxf(tmax, v);
          }
      }
      const float m_new = fmaxf(m[h], group_max(tmax, 4));
      if (edge) {
#pragma unroll
        for (int nf = 0; nf < LK / 8; ++nf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = c[nf][2 * h + e];
            sum += v == FLASH_NEG_INF ? 0.f : ex2(v - m_new);
          }
      } else {
#pragma unroll
        for (int nf = 0; nf < LK / 8; ++nf)
#pragma unroll
          for (int e = 0; e < 2; ++e) sum += ex2(c[nf][2 * h + e] - m_new);
      }
      l[h] = l[h] * ex2(m[h] - m_new) + group_sum(sum, 4);
      m[h] = m_new;
    }
    __syncthreads();  // buffer j % kLseBuf is free for tile j + kLseBuf
  }
  if (t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h;
      const long long bh = static_cast<long long>(b) * NV + head;
      const float lse2 = m[h] + log2f(l[h]);
      if (row < S) lse[bh * S + row] = lse2 * 0.6931471805599453f;
      ws[bh * s_pad + row] = row < S ? lse2 : INFINITY;
    }
}

// ------------------------------------------------------------- 2. P @ content

constexpr int kSlab = 192;        // columns of d a block takes: 4 slabs at d 768
constexpr int kBox = 64 * 128;    // a TMA box: 64 rows of 64 bf16 (128 bytes), swizzled
constexpr int kCtxThreads = 384;  // two consumer warpgroups, one producer

// A stage of the ring: the content slab (three boxes of 64 keys x 64
// columns) and the key tile (one box); a head's first stage of a run also
// brings one or two 64-row query slots and their row LSEs. The exchange at
// the end of a block (rows 64) reuses the ring's memory.
constexpr uint32_t kK = kSlab / 64 * kBox, kQ = kK + kBox, kL = kQ + 2 * kBox;
constexpr uint32_t kBytes = kQ;  // TMA bytes of a stage without query slots
constexpr int kStage = (kL + 2 * 64 * 4 + 1023) / 1024 * 1024;
constexpr int kStages = 4;
constexpr int kRing = kStages * kStage;
constexpr size_t kCtxSmem = 1024 + kRing + 16 * kStages;
constexpr int kXld = kSlab / 2 + 8;  // exchange rows (floats): 32 bytes of shift
static_assert(kSlab == 192 && kCtxSmem <= 232448 && 2 * 64 * kXld * 4 <= kRing, "shared memory");

struct CtxArgs {
  const float* ws;  // (B * NV, s_pad) row LSEs in log2 units, +inf past S
  bf16* out;        // (B, S, D)
  int S, NV, DNV, D, s_pad;
  int n_keys;       // 64-key tiles, ceil(S / 64)
  int n_rows;       // ROWS-row query tiles, ceil(S / ROWS)
  float scale_log2;
};

// 64-key tiles that a 128-row tile sees
__device__ __forceinline__ int key_tiles128(int tile, int n_keys) {
  return min(n_keys, 2 * tile + 2);
}

// d (64 x 192, f32, the warpgroup's accumulator fragments) = A (64 x 16,
// bf16 in registers: warp w's 16 rows in the m16n8k16 A layout) * B (16 x
// 192, N-major in shared memory: the transpose bit set), plus d if acc
__device__ __forceinline__ void wgmma_ra192(float* d, const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// columns (col, col + 1) of row `row` of out, rounded once
__device__ __forceinline__ void store_out(const CtxArgs& a, int b, int row, int col, float v0,
                                          float v1) {
  if (row < a.S && col < a.D)  // D % 8 == 0: the pair stays inside
    *reinterpret_cast<__nv_bfloat162*>(a.out + (static_cast<long long>(b) * a.S + row) * a.D +
                                       col) = __floats2bfloat162_rn(v0, v1);
}

// a warpgroup's accumulator: its warp's 16 rows from r0, the slab from d0
__device__ __forceinline__ void store_acc(const float (&acc)[kSlab / 2], const CtxArgs& a, int b,
                                          int r0, int d0, int g, int t) {
#pragma unroll
  for (int j = 0; j < kSlab / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store_out(a, b, r0 + g + 8 * h, d0 + 8 * j + 2 * t, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// accumulator n8 chunks [J0, J0 + kSlab / 16) of a warp's 16 rows (rl, rl +
// 8 within the tile) into the exchange area x
template <int J0>
__device__ __forceinline__ void stash_half(const float (&acc)[kSlab / 2], float* x, int rl, int t) {
#pragma unroll
  for (int jj = 0; jj < kSlab / 16; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(x + (rl + 8 * h) * kXld + 8 * jj + 2 * t) =
          make_float2(acc[4 * (J0 + jj) + 2 * h], acc[4 * (J0 + jj) + 2 * h + 1]);
}

// the same chunks plus the other warpgroup's partial sums in x, stored
template <int J0>
__device__ __forceinline__ void finish_half(const float (&acc)[kSlab / 2], const float* x,
                                            const CtxArgs& a, int b, int r0, int rl, int d0,
                                            int g, int t) {
#pragma unroll
  for (int jj = 0; jj < kSlab / 16; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 o = *reinterpret_cast<const float2*>(x + (rl + 8 * h) * kXld + 8 * jj + 2 * t);
      store_out(a, b, r0 + g + 8 * h, d0 + 8 * (J0 + jj) + 2 * t,
                acc[4 * (J0 + jj) + 2 * h] + o.x, acc[4 * (J0 + jj) + 2 * h + 1] + o.y);
    }
}

// The producer's run of stages: for each head, key tiles [kt0, kt1) of the
// slab from d0; a head's first stage also brings nq 64-row query slots, from
// rows q0 and q1, with their row LSEs.
__device__ __forceinline__ void produce_run(const CUtensorMap* map_c, const CUtensorMap* map_k,
                                            const CUtensorMap* map_q, const CtxArgs& a, int& n,
                                            uint32_t base, uint32_t full, uint32_t empty, int d0,
                                            int b, int kt0, int kt1, int nq, int q0, int q1) {
  for (int head = 0; head < a.NV; ++head)
    for (int kt = kt0; kt < kt1; ++kt, ++n) {
      const int s = n % kStages;
      if (n >= kStages) mbar_wait(empty + 8 * s, (n / kStages - 1) & 1);
      const uint32_t st = base + s * kStage, bar = full + 8 * s;
      mbar_expect_tx(bar, kt == kt0 ? kBytes + nq * (kBox + 256) : kBytes);
#pragma unroll
      for (int j = 0; j < kSlab / 64; ++j)
        tma_load_4d(st + j * kBox, map_c, bar, d0 + 64 * j, head, 64 * kt, b);
      tma_load_4d(st + kK, map_k, bar, 0, head, 64 * kt, b);
      if (kt == kt0)
        for (int j = 0; j < nq; ++j) {
          const int q = j == 0 ? q0 : q1;
          tma_load_4d(st + kQ + j * kBox, map_q, bar, 0, head, q, b);
          bulk_load(st + kL + j * 256, a.ws + (static_cast<long long>(b) * a.NV + head) * a.s_pad + q,
                    256, bar);
        }
    }
}

// A consumer warpgroup's run of stages, in produce_run's order (n counts the
// ring's stages): each adds P (the warp's 16 rows from r0 x KW keys from
// wkey of the key tile) @ content into acc. qoff: the warp's first row in
// the stage's query slots and LSE rows. fresh: the run's first product
// overwrites acc. No instruction but wgmma defines acc between a fresh
// run's first product and the run's last wait.
template <int KW>
__device__ __forceinline__ void consume_run(float (&acc)[kSlab / 2], const CtxArgs& a, int& n,
                                            uint32_t base, const unsigned char* gbase,
                                            uint32_t full, uint32_t empty, int r0, int qoff,
                                            int wkey, int kt0, int kt1, bool fresh) {
  const int tid = threadIdx.x & 127, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, m8 = lane >> 3;
  const int ksteps = (a.DNV + 15) / 16, nkt = kt1 - kt0, n_st = a.NV * nkt;
  uint32_t qa[DNVP / 16][4], pa[2][KW / 16][4];
  float lse2[2];
  for (int i = 0; i < n_st; i += 2) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // P buffer u: the products of the last stage may still read the other
      if (i + u < n_st) {
        const int head = (i + u) / nkt, kt = kt0 + (i + u) - head * nkt, s = n % kStages;
        mbar_wait(full + 8 * s, (n / kStages) & 1);
        const uint32_t st = base + s * kStage;
        if (kt == kt0) {  // the head's query fragments and row LSEs
#pragma unroll
          for (int kq = 0; kq < DNVP / 16; ++kq) {
            const int row = qoff + (m8 & 1) * 8 + (lane & 7), chunk = 2 * kq + (m8 >> 1);
            if (kq < ksteps) ldsm_x4(qa[kq], st + kQ + row * 128 + ((chunk ^ (row & 7)) << 4));
          }
          const float* ls = reinterpret_cast<const float*>(gbase + s * kStage + kL);
          lse2[0] = ls[qoff + g];
          lse2[1] = ls[qoff + g + 8];
        }
        const int k0 = 64 * kt + wkey;  // the warpgroup's first key
        if (k0 > r0 + 15) {             // wholly past the warp's rows
#pragma unroll
          for (int kk = 0; kk < KW / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) pa[u][kk][e] = 0u;
        } else {
          float c[KW / 8][4];
          zero(c);
#pragma unroll
          for (int kq = 0; kq < DNVP / 16; ++kq) {
            if (kq >= ksteps) break;
#pragma unroll
            for (int p = 0; p < KW / 16; ++p) {
              const int key = wkey + 16 * p + 8 * (m8 >> 1) + (lane & 7);
              const int chunk = 2 * kq + (m8 & 1);
              uint32_t bk[4];
              ldsm_x4(bk, st + kK + key * 128 + ((chunk ^ (key & 7)) << 4));
              mma_16816(c[2 * p], qa[kq], bk);
              mma_16816(c[2 * p + 1], qa[kq], bk + 2);
            }
          }
          // p = 2^(s * scale * log2 e - lse2), masked where the stage
          // straddles the diagonal or the end (warp-uniform)
          const bool edge = k0 + KW - 1 > r0 || k0 + KW > a.S;
#pragma unroll
          for (int nf = 0; nf < KW / 8; ++nf) {
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = r0 + g + 8 * (e >> 1), key = k0 + 8 * nf + 2 * t + (e & 1);
              p[e] = ex2(c[nf][e] * a.scale_log2 - lse2[e >> 1]);
              if (edge && (key > row || key >= a.S)) p[e] = 0.f;
            }
            pa[u][nf >> 1][(nf & 1) * 2] = pack_bf16x2(p[0], p[1]);
            pa[u][nf >> 1][(nf & 1) * 2 + 1] = pack_bf16x2(p[2], p[3]);
          }
        }
        // acc += P (64 x KW) @ content[the warpgroup's keys, the slab]:
        // k16 steps move 16 rows (2048 bytes) down the boxes, which lie
        // kBox apart (leading offset), 8-row groups 1024 bytes apart
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < KW / 16; ++kk)
          wgmma_ra192(acc, pa[u][kk], smem_desc(st + (wkey + 16 * kk) * 128, kBox, 1024),
                      !fresh || i + u > 0 || kk > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // stage n - 1 is done
        fence_regs(pa[u ^ 1]);
        if (i + u > 0 && tid == 0) mbar_arrive(empty + 8 * ((n - 1) % kStages));
        ++n;
      }
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  fence_regs(pa[0]);
  fence_regs(pa[1]);
  if (n_st > 0 && tid == 0) mbar_arrive(empty + 8 * ((n - 1) % kStages));
}

// A block owns the query-row tiles hi = n - 1 - x and lo = x (one where they
// meet) of batch row z and the column slab y.
// ROWS 128: hi, then lo; warpgroup w takes rows [64 w, 64 w + 64) of the
// tile and all 64 keys of each stage.
// ROWS 64: first the key tiles [0, lo] of every head, warpgroup 0 on tile
// hi and 1 on tile lo, which then stores tile lo; then the key tiles (lo,
// hi], both on tile hi, warpgroup w taking keys [32 w, 32 w + 32) of each
// stage; at the end the two add their sums for tile hi through shared
// memory. Each content tile is read once a block, and every block does the
// same products (n + 1 tiles of 64 x 64 a head).
template <int ROWS>
__global__ void __launch_bounds__(kCtxThreads, 1)
ctx_wgmma_kernel(const __grid_constant__ CUtensorMap map_c, const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_q, const CtxArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle's 1024-byte atoms
  unsigned char* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full = base + kRing, empty = full + 8 * kStages;
  const int hi = a.n_rows - 1 - static_cast<int>(blockIdx.x), lo = blockIdx.x;
  const int d0 = blockIdx.y * kSlab, b = blockIdx.z, wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
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
      if constexpr (ROWS == 128) {
        for (int r = 0; r < (hi == lo ? 1 : 2); ++r) {
          const int tile = r == 0 ? hi : lo;
          produce_run(&map_c, &map_k, &map_q, a, n, base, full, empty, d0, b, 0,
                      key_tiles128(tile, a.n_keys), 2, 128 * tile, 128 * tile + 64);
        }
      } else {
        if (hi != lo)
          produce_run(&map_c, &map_k, &map_q, a, n, base, full, empty, d0, b, 0, lo + 1, 2,
                      64 * hi, 64 * lo);
        produce_run(&map_c, &map_k, &map_q, a, n, base, full, empty, d0, b, hi != lo ? lo + 1 : 0,
                    hi + 1, 1, 64 * hi, 0);
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    float acc[kSlab / 2];
    int n = 0;  // stages consumed
    if constexpr (ROWS == 128) {
      for (int r = 0; r < (hi == lo ? 1 : 2); ++r) {
        const int tile = r == 0 ? hi : lo, r0 = 128 * tile + 64 * wg + 16 * warp;
        consume_run<64>(acc, a, n, base, gbase, full, empty, r0, 64 * wg + 16 * warp, 0, 0,
                        key_tiles128(tile, a.n_keys), true);
        store_acc(acc, a, b, r0, d0, g, t);
      }
    } else {
      if (hi != lo) {
        const int r0 = 64 * (wg == 0 ? hi : lo) + 16 * warp;
        consume_run<64>(acc, a, n, base, gbase, full, empty, r0, 64 * wg + 16 * warp, 0, 0, lo + 1,
                        true);
        if (wg == 1) store_acc(acc, a, b, r0, d0, g, t);
      }
      const int r0 = 64 * hi + 16 * warp, rl = 16 * warp + g;
      consume_run<32>(acc, a, n, base, gbase, full, empty, r0, 16 * warp, 32 * wg,
                      hi != lo ? lo + 1 : 0, hi + 1, wg == 1 || hi == lo);
      // warpgroup 0 finishes the slab's first 96 columns, 1 the rest, through
      // the ring's memory (every stage landed, every product done)
      float* x = reinterpret_cast<float*>(gbase);
      float* x1 = x + 64 * kXld;
      bar_sync(1, 256);
      if (wg == 0)
        stash_half<kSlab / 16>(acc, x, rl, t);
      else
        stash_half<0>(acc, x1, rl, t);
      bar_sync(1, 256);
      if (wg == 0)
        finish_half<0>(acc, x1, a, b, r0, rl, d0, g, t);
      else
        finish_half<kSlab / 16>(acc, x, a, b, r0, rl, d0, g, t);
    }
  }
}

// ------------------------------------------------------------- SIMT

constexpr int BQ = 32, BKV = 32, DC = 128, DNV_MAX = 64, kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ctx_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ content, T* __restrict__ out,
                      float* __restrict__ lse, int S, int NV, int DNV,
                      int D, long long q_sb, long long q_st, long long q_sh, long long k_sb,
                      long long k_st, long long k_sh, long long c_sb, long long c_st,
                      long long c_sh, float scale) {
  __shared__ float Qs[BQ][DNV_MAX + 1];
  __shared__ float Ks[BKV][DNV_MAX + 1];
  __shared__ float Cs[BKV][DC];
  __shared__ float Ps[BQ][BKV + 1];

  const int q0 = blockIdx.x * BQ, d0 = blockIdx.y * DC, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid >> 3, c = tid & 7;  // query row in the tile, lane in its group of 8
  const int qi = q0 + r;
  const int kv_end = min(S, q0 + BQ);

  float total[DC / 8];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) total[j] = 0.f;

  for (int head = 0; head < NV; ++head) {
    const T* qb = q + b * q_sb + head * q_sh;
    const T* kb = k + b * k_sb + head * k_sh;
    const T* cb = content + b * c_sb + head * c_sh + d0;
    __syncthreads();  // the previous head's last tile is consumed
    for (int idx = tid; idx < BQ * DNV; idx += kThreads) {
      const int rr = idx / DNV, dd = idx % DNV;
      Qs[rr][dd] = q0 + rr < S ? to_f32(qb[(q0 + rr) * q_st + dd]) : 0.f;
    }
    float m = FLASH_NEG_INF, l = 0.f;
    float o[DC / 8];
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) o[j] = 0.f;

    for (int j0 = 0; j0 < kv_end; j0 += BKV) {
      __syncthreads();
      for (int idx = tid; idx < BKV * DNV; idx += kThreads) {
        const int rr = idx / DNV, dd = idx % DNV;
        Ks[rr][dd] = j0 + rr < S ? to_f32(kb[(j0 + rr) * k_st + dd]) : 0.f;
      }
      for (int idx = tid; idx < BKV * DC; idx += kThreads) {
        const int rr = idx / DC, cc = idx % DC;
        Cs[rr][cc] = (j0 + rr < S && d0 + cc < D) ? to_f32(cb[(j0 + rr) * c_st + cc]) : 0.f;
      }
      __syncthreads();

      float s[BKV / 8];
      float tile_max = FLASH_NEG_INF;
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i) {
        const int kk = c + 8 * i;
        float acc = 0.f;
        for (int dd = 0; dd < DNV; ++dd) acc += Qs[r][dd] * Ks[kk][dd];
        const int kpos = j0 + kk;
        const bool valid = kpos < S && kpos <= qi;
        s[i] = valid ? acc * scale : FLASH_NEG_INF;
        tile_max = fmaxf(tile_max, s[i]);
      }
      const float m_new = fmaxf(m, group_max(tile_max, 8));
      const float corr = expf(m - m_new);
      float tile_sum = 0.f;
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i) {
        const float p = s[i] == FLASH_NEG_INF ? 0.f : expf(s[i] - m_new);
        Ps[r][c + 8 * i] = p;
        tile_sum += p;
      }
      l = l * corr + group_sum(tile_sum, 8);
      m = m_new;
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) o[j] *= corr;
      __syncwarp();  // the row's eight lanes share one warp
#pragma unroll 8
      for (int kk = 0; kk < BKV; ++kk) {
        const float p = Ps[r][kk];
#pragma unroll
        for (int j = 0; j < DC / 8; ++j) o[j] += p * Cs[kk][c + 8 * j];
      }
    }
    const float l_safe = l == 0.f ? 1.f : l;
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) total[j] += o[j] * inv;
    if (blockIdx.y == 0 && c == 0 && qi < S)
      lse[(static_cast<long long>(b) * NV + head) * S + qi] = m + logf(l_safe);
  }

  if (qi >= S) return;
  T* orow = out + (static_cast<long long>(b) * S + qi) * D + d0;
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
    if (d0 + c + 8 * j < D) orow[c + 8 * j] = from_f32<T>(total[j]);
}

template <typename T>
int launch_simt(const void* q, const void* k, const void* content, void* lse, void* out,
                long long B,
                long long S, long long NV, long long DNV, long long D, long long q_sb,
                long long q_st, long long q_sh, long long k_sb, long long k_st, long long k_sh,
                long long c_sb, long long c_st, long long c_sh, float scale,
                cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((S + BQ - 1) / BQ),
                  static_cast<unsigned>((D + DC - 1) / DC), static_cast<unsigned>(B));
  fused_ctx_simt_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(content),
      static_cast<T*>(out), static_cast<float*>(lse), static_cast<int>(S), static_cast<int>(NV),
      static_cast<int>(DNV),
      static_cast<int>(D), q_sb, q_st, q_sh, k_sb, k_st, k_sh, c_sb, c_st, c_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

// a (b, s, nv, inner) bf16 view with element strides (sb, st, sh, 1), in
// boxes of 64 positions x 64 columns of one head and batch row (128-byte
// swizzle); positions past s and columns past inner read as zeros
cudaError_t view_map(CUtensorMap* map, const void* p, long long inner, long long nv, long long s,
                     long long b, long long sh, long long st, long long sb) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  // a dimension of one element reads no stride: give it the packed one
  if (nv == 1) sh = inner;
  if (s == 1) st = sh * nv;
  if (b == 1) sb = st * s;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(nv),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1}, step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int ROWS>
cudaError_t launch_wgmma(const void* q, const void* k, const void* content, CtxArgs a, long long B,
                         long long q_sb, long long q_st, long long q_sh, long long k_sb,
                         long long k_st, long long k_sh, long long c_sb, long long c_st,
                         long long c_sh, cudaStream_t stream) {
  CUtensorMap mc, mk, mq;
  cudaError_t err = view_map(&mc, content, a.D, a.NV, a.S, B, c_sh, c_st, c_sb);
  if (err == cudaSuccess) err = view_map(&mk, k, a.DNV, a.NV, a.S, B, k_sh, k_st, k_sb);
  if (err == cudaSuccess) err = view_map(&mq, q, a.DNV, a.NV, a.S, B, q_sh, q_st, q_sb);
  if (err == cudaSuccess) err = allow_smem<ctx_wgmma_kernel<ROWS>>(kCtxSmem);
  if (err != cudaSuccess) return err;
  a.n_rows = (a.S + ROWS - 1) / ROWS;
  const dim3 grid(static_cast<unsigned>((a.n_rows + 1) / 2),
                  static_cast<unsigned>((a.D + kSlab - 1) / kSlab), static_cast<unsigned>(B));
  ctx_wgmma_kernel<ROWS><<<grid, kCtxThreads, kCtxSmem, stream>>>(mc, mk, mq, a);
  return cudaGetLastError();
}

int launch_tc(const void* q, const void* k, const void* content, void* lse, void* ws, void* out,
              long long B, long long S, long long NV, long long DNV, long long D, long long q_sb,
              long long q_st, long long q_sh, long long k_sb, long long k_st, long long k_sh,
              long long c_sb, long long c_st, long long c_sh, long long s_pad, long long rows,
              float scale, cudaStream_t stream) {
  if (s_pad < S || s_pad % 128 || (rows != 64 && rows != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * kLog2e;
  const dim3 lse_grid(static_cast<unsigned>(s_pad / LQ), static_cast<unsigned>(NV),
                      static_cast<unsigned>(B));
  ctx_lse_kernel<<<lse_grid, kLseThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<float*>(lse),
      static_cast<float*>(ws), static_cast<int>(S), static_cast<int>(NV), static_cast<int>(DNV),
      static_cast<int>(s_pad), q_sb, q_st, q_sh, k_sb, k_st, k_sh, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CtxArgs a{static_cast<const float*>(ws), static_cast<bf16*>(out), static_cast<int>(S),
            static_cast<int>(NV), static_cast<int>(DNV), static_cast<int>(D),
            static_cast<int>(s_pad), static_cast<int>((S + 63) / 64), 0, scale_log2};
  return static_cast<int>(rows == 64 ? launch_wgmma<64>(q, k, content, a, B, q_sb, q_st, q_sh,
                                                         k_sb, k_st, k_sh, c_sb, c_st, c_sh, stream)
                                     : launch_wgmma<128>(q, k, content, a, B, q_sb, q_st, q_sh,
                                                          k_sb, k_st, k_sh, c_sb, c_st, c_sh,
                                                          stream));
}

bool aligned16(const void* p, long long D, long long sb, long long st, long long sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && D % 8 == 0 && sb % 8 == 0 && st % 8 == 0 &&
         sh % 8 == 0;
}

}  // namespace

// lse: f32 output of B * NV * S elements, the (batch, head, row) natural-log
// log-sum-exps; ws: an f32 workspace of B * NV * s_pad elements (s_pad a
// multiple of 128, at least S) for the bf16 tensor-core path; rows: its
// query-row tiles, 64 or 128 (ops/backpack_kernels._k4_rows)
extern "C" int fused_contextualization_launch(const void* q, const void* k, const void* content,
                                              void* lse, void* ws, void* out, long long B,
                                              long long S, long long NV, long long DNV,
                                              long long D, long long q_sb, long long q_st,
                                              long long q_sh, long long k_sb, long long k_st,
                                              long long k_sh, long long c_sb, long long c_st,
                                              long long c_sh, long long s_pad, long long rows,
                                              float scale, long long dtype,
                                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K4_ARGS q, k, content, lse, out, B, S, NV, DNV, D, q_sb, q_st, q_sh, k_sb, k_st, k_sh, \
                c_sb, c_st, c_sh, scale, st
  if (dtype == DT_BF16) {
    const bool tc = aligned16(content, D, c_sb, c_st, c_sh) &&
                    aligned16(q, DNV, q_sb, q_st, q_sh) && aligned16(k, DNV, k_sb, k_st, k_sh);
    if (tc)
      return launch_tc(q, k, content, lse, ws, out, B, S, NV, DNV, D, q_sb, q_st, q_sh, k_sb,
                       k_st, k_sh, c_sb, c_st, c_sh, s_pad, rows, scale, st);
    return launch_simt<bf16>(K4_ARGS);
  }
  if (dtype == DT_F32) return launch_simt<float>(K4_ARGS);
#undef K4_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
