// K4: fused Backpack contextualization (inference forward).
//
// Replaces the TPU kernel backpacks_flash_attn_tpu/ops/backpack_kernels.py
// _fused_ctx_infer (:281, Pallas body _fused_ctx_infer_kernel :119):
//   out[b,t,:] = sum_k sum_{j<=t} softmax_j(scale * q[b,t,k] . k[b,j,k]) content[b,j,k,:]
// with alpha (b, nv, s, s) never stored.
//
// Bound on the H100: bytes. Per (query, key) pair and sense head it does
// dnv (48) multiply-adds for the score and d (768) for the value sum; at
// (8, 512, 16, 768) that is ~27 Gflop (0.028 ms of bf16 tensor-core time)
// against ~0.12 GB of q/k/content/out (0.036 ms of HBM time).
//
// bf16 design (tensor cores, two launches):
// 1. ctx_lse_kernel: each (64-row query tile, head, batch row) block runs
//    an online softmax over its causal keys (mma.sync scores, f32) and
//    writes each row's log-sum-exp to an f32 workspace (b, nv, s). It is
//    cheap (48 multiply-adds per pair) and has thousands of blocks.
// 2. ctx_pv_kernel: one 256-thread block per (128-row query chunk,
//    96-column slab of d, batch row), heavy (late) chunks first. Each of
//    the 8 warps owns 16 rows x 96 columns of the f32 output in mma.sync
//    accumulators. The block loops over the sense heads and their causal
//    64-key tiles; per tile each warp computes its own 16 x 64 scores,
//    turns them into exactly normalized probabilities 2^(s - lse) in
//    registers, packs them to bf16 as the A operand of the next product
//    (the FlashAttention-2 register layout), and adds P @ content straight
//    into the accumulator. Because every head's probabilities are final
//    before the product, one accumulator serves all heads: no rescaling,
//    no atomics, a deterministic sum.
//    Why column slabs: a content row is 16 x 768 bf16 = 24.6 KB per token,
//    so a design that keeps whole output rows per block (few rows) re-reads
//    the content prefix once per query tile; measured, that traffic bound
//    16- and 32-row tiles at 0.9-1.1 ms. A slab block serves 128 rows per
//    content read, at the price of recomputing the 48-wide scores once per
//    slab (8 times). Key and content tiles stream through a 4-deep cp.async
//    ring in shared memory; ldmatrix.trans reads the content tile as the B
//    operand. 90 KB of shared memory: two blocks per SM. What bounds it now
//    is the loads of the heavy chunks (each SM keeps only so many requests
//    in flight): TMA bulk copies and balanced chunks are the next step.
//    Needs 16-byte aligned q/k/content rows and dnv % 8 == 0.
//
// f32 operands, and bf16 operands that are not aligned so, take the SIMT
// kernel below: one block per (32-row query tile, 128-column slice of d,
// batch row), an online softmax per head with the f32 output slice in
// registers, recomputing the scores once per slice.
#include "common.cuh"

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr int DNVP = 64, KLD = DNVP + 8;  // padded key row (16-byte aligned, conflict-free)
constexpr float kLog2e = 1.4426950408889634f;

// A fragments of the 16 query rows starting at r0 for every 16-wide step of
// dnv (rows past S and columns past DNV are zero): a[ks] = {(g, 2t), (g + 8,
// 2t), (g, 2t + 8), (g + 8, 2t + 8)} pairs.
__device__ __forceinline__ void load_q_frags(uint32_t (&a)[DNVP / 16][4],
                                             const __nv_bfloat16* qb, long long q_st, int r0,
                                             int S, int DNV, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < DNVP / 16; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + 8 * (e & 1), col = ks * 16 + 2 * t + 8 * (e >> 1);
      a[ks][e] = (row < S && col < DNV) ? ld32(qb + row * q_st + col) : 0u;
    }
}

// ------------------------------------------------------------- 1. row LSE

constexpr int LQ = 64, LK = 64, kLseThreads = 128;

__global__ void __launch_bounds__(kLseThreads)
ctx_lse_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               float* __restrict__ lse, int S, int NV, int DNV, long long q_sb, long long q_st,
               long long q_sh, long long k_sb, long long k_st, long long k_sh, float scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[LK][KLD];
  const int q0 = blockIdx.x * LQ, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16;
  const int ksteps = (DNV + 15) / 16;
  const __nv_bfloat16* kb = k + b * k_sb + head * k_sh;

  uint32_t qa[DNVP / 16][4];
  load_q_frags(qa, q + b * q_sb + head * q_sh, q_st, r0, S, DNV, g, t);
  float m[2] = {FLASH_NEG_INF, FLASH_NEG_INF}, l[2] = {0.f, 0.f};
  // key columns [DNV, DNVP) stay zero; the rest arrive as 16-byte chunks
  // (DNV % 8 == 0), every chunk of a tile in flight at once
  for (int idx = tid; idx < LK * DNVP; idx += kLseThreads)
    if (idx % DNVP >= DNV) Ks[idx / DNVP][idx % DNVP] = __float2bfloat16(0.f);
  constexpr int kChunks = LK * DNVP / 8 / kLseThreads;
  const int chunks = DNV / 8;

  const int kv_end = min(S, q0 + LQ);
  for (int j0 = 0; j0 < kv_end; j0 += LK) {
    uint4 kreg[kChunks];
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int idx = tid + i * kLseThreads, rr = idx / chunks, cc = (idx % chunks) * 8;
      kreg[i] = (rr < LK && j0 + rr < S)
                    ? *reinterpret_cast<const uint4*>(kb + (j0 + rr) * k_st + cc)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int idx = tid + i * kLseThreads, rr = idx / chunks, cc = (idx % chunks) * 8;
      if (rr < LK) *reinterpret_cast<uint4*>(&Ks[rr][cc]) = kreg[i];
    }
    __syncthreads();
    float c[LK / 8][4];
#pragma unroll
    for (int nf = 0; nf < LK / 8; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[nf][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DNVP / 16; ++ks) {
      if (ks >= ksteps) break;
#pragma unroll
      for (int nf = 0; nf < LK / 8; ++nf) {
        const uint32_t bfr[2] = {ld32(&Ks[nf * 8 + g][ks * 16 + 2 * t]),
                                 ld32(&Ks[nf * 8 + g][ks * 16 + 2 * t + 8])};
        mma_16816(c[nf], qa[ks], bfr);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h;
      float tmax = FLASH_NEG_INF;
#pragma unroll
      for (int nf = 0; nf < LK / 8; ++nf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = j0 + nf * 8 + 2 * t + e;
          float& v = c[nf][2 * h + e];
          v = (key < S && key <= row) ? v * scale : FLASH_NEG_INF;
          tmax = fmaxf(tmax, v);
        }
      const float m_new = fmaxf(m[h], group_max(tmax, 4));
      float sum = 0.f;
#pragma unroll
      for (int nf = 0; nf < LK / 8; ++nf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = c[nf][2 * h + e];
          sum += v == FLASH_NEG_INF ? 0.f : expf(v - m_new);
        }
      l[h] = l[h] * expf(m[h] - m_new) + group_sum(sum, 4);
      m[h] = m_new;
    }
  }
  if (t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h;
      if (row < S) lse[(static_cast<long long>(b) * NV + head) * S + row] = m[h] + logf(l[h]);
    }
}

// ------------------------------------------------------------- 2. P @ content

constexpr int QR = 128, TK = 64, DS = 96, NBUF = 4, kPvThreads = 256;
constexpr int CS_LD = DS + 8;  // 208-byte rows: 16-byte aligned, ldmatrix conflict-free
constexpr int kPvStage = TK * CS_LD + TK * KLD;  // bf16 elements of one stage's buffers
constexpr int kPvSmem = NBUF * kPvStage * 2;

__global__ void __launch_bounds__(kPvThreads, 2)
ctx_pv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ content, const float* __restrict__ lse,
              __nv_bfloat16* __restrict__ out, int S, int NV, int DNV, int D, long long q_sb,
              long long q_st, long long q_sh, long long k_sb, long long k_st, long long k_sh,
              long long c_sb, long long c_st, long long c_sh, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  // stage buffer i: content rows [TK][CS_LD], then key rows [TK][KLD]
  __nv_bfloat16* bufs = reinterpret_cast<__nv_bfloat16*>(smem);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * QR;  // heavy (late) row chunks first
  const int d0 = blockIdx.y * DS, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16;  // this warp's 16 query rows
  const int ksteps = (DNV + 15) / 16;
  const int kv_end = min(S, q0 + QR);  // causal: no row of the chunk sees past it
  const int n_kt = (kv_end + TK - 1) / TK, n_stages = NV * n_kt;
  const float scale_log2 = scale * kLog2e;  // p = 2^(s * scale * log2 e - lse * log2 e)

  // key columns [DNV, DNVP) are never written by the loads below
  for (int idx = tid; idx < NBUF * TK * DNVP; idx += kPvThreads) {
    const int i = idx / (TK * DNVP), rr = (idx / DNVP) % TK, dd = idx % DNVP;
    if (dd >= DNV) bufs[i * kPvStage + TK * CS_LD + rr * KLD + dd] = __float2bfloat16(0.f);
  }

  // stage n = (head n / n_kt, keys [j0, j0 + TK)): the content slab and key
  // rows into buffer n % NBUF (cp.async, one commit group; zeros past S and
  // past D)
  auto load_stage = [&](int n) {
    const int head = n / n_kt, j0 = (n % n_kt) * TK;
    __nv_bfloat16* cs = bufs + (n % NBUF) * kPvStage;
    __nv_bfloat16* ks = cs + TK * CS_LD;
    const __nv_bfloat16* cb = content + b * c_sb + head * c_sh + d0;
    for (int idx = tid; idx < TK * (DS / 8); idx += kPvThreads) {
      const int rr = idx / (DS / 8), cc = (idx % (DS / 8)) * 8;
      __nv_bfloat16* dst = cs + rr * CS_LD + cc;
      if (j0 + rr < S && d0 + cc < D)
        cp_async16(dst, cb + (j0 + rr) * c_st + cc);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    const __nv_bfloat16* kb = k + b * k_sb + head * k_sh;
    const int chunks = DNV / 8;
    for (int idx = tid; idx < TK * chunks; idx += kPvThreads) {
      const int rr = idx / chunks, cc = (idx % chunks) * 8;
      __nv_bfloat16* dst = ks + rr * KLD + cc;
      if (j0 + rr < S)
        cp_async16(dst, kb + (j0 + rr) * k_st + cc);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  };

  // the head's query fragments and row LSEs, fetched one head ahead
  uint32_t qa[DNVP / 16][4], qa_next[DNVP / 16][4];
  float row_lse[2], row_lse_next[2];
  auto fetch_head = [&](int head, uint32_t (&a)[DNVP / 16][4], float (&ls)[2]) {
    load_q_frags(a, q + b * q_sb + head * q_sh, q_st, r0, S, DNV, g, t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h;
      ls[h] = row < S ? lse[(static_cast<long long>(b) * NV + head) * S + row] * kLog2e : 0.f;
    }
  };

  float acc[DS / 8][4];
#pragma unroll
  for (int ni = 0; ni < DS / 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;

  fetch_head(0, qa, row_lse);
#pragma unroll
  for (int n = 0; n < NBUF - 1; ++n) {
    if (n < n_stages) load_stage(n);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int n = 0; n < n_stages; ++n) {
    const int head = n / n_kt, tile = n % n_kt, j0 = tile * TK;
    // buffer (n + NBUF - 1) % NBUF was released by the barrier ending stage n - 1
    if (n + NBUF - 1 < n_stages) load_stage(n + NBUF - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    if (tile == 0 && head + 1 < NV) fetch_head(head + 1, qa_next, row_lse_next);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NBUF - 1));  // stage n has landed
    __syncthreads();

    if (r0 < S && j0 <= r0 + 15) {  // warp-uniform: causal keys left for these rows
      const __nv_bfloat16* cs = bufs + (n % NBUF) * kPvStage;
      const __nv_bfloat16* ks = cs + TK * CS_LD;
      // scores of the warp's 16 rows x TK keys
      float c[TK / 8][4];
#pragma unroll
      for (int nf = 0; nf < TK / 8; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[nf][e] = 0.f;
#pragma unroll
      for (int kq = 0; kq < DNVP / 16; ++kq) {
        if (kq >= ksteps) break;
#pragma unroll
        for (int nf = 0; nf < TK / 8; ++nf) {
          const __nv_bfloat16* kr = ks + (nf * 8 + g) * KLD + kq * 16 + 2 * t;
          const uint32_t bfr[2] = {ld32(kr), ld32(kr + 8)};
          mma_16816(c[nf], qa[kq], bfr);
        }
      }
      // probabilities exp(scale * s - lse), masked, packed as A fragments
      uint32_t pa[TK / 16][4];
      const bool masked = j0 + TK - 1 > r0 || j0 + TK > S;  // warp-uniform
#pragma unroll
      for (int nf = 0; nf < TK / 8; ++nf) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + g + 8 * (e >> 1), key = j0 + nf * 8 + 2 * t + (e & 1);
          p[e] = exp2f(c[nf][e] * scale_log2 - row_lse[e >> 1]);
          if (masked && (key >= S || key > row)) p[e] = 0.f;
        }
        pa[nf >> 1][(nf & 1) * 2] = pack_bf16x2(p[0], p[1]);
        pa[nf >> 1][(nf & 1) * 2 + 1] = pack_bf16x2(p[2], p[3]);
      }
      // acc += P @ content[keys, the block's DS columns]
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
        for (int nj = 0; nj < DS / 16; ++nj) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, cs + (kk * 16 + (lane & 15)) * CS_LD + nj * 16 + (lane >> 4) * 8);
          mma_16816(acc[2 * nj], pa[kk], bfr);
          mma_16816(acc[2 * nj + 1], pa[kk], bfr + 2);
        }
    }
    __syncthreads();  // buffer n % NBUF is free for stage n + NBUF
    if (tile == n_kt - 1 && head + 1 < NV) {
#pragma unroll
      for (int kq = 0; kq < DNVP / 16; ++kq)
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[kq][e] = qa_next[kq][e];
      row_lse[0] = row_lse_next[0];
      row_lse[1] = row_lse_next[1];
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= S) continue;
    __nv_bfloat16* orow = out + (static_cast<long long>(b) * S + row) * D;
#pragma unroll
    for (int ni = 0; ni < DS / 8; ++ni) {
      const int col = d0 + ni * 8 + 2 * t;  // D % 8 == 0: pairs stay inside
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[ni][2 * h], acc[ni][2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------- SIMT

constexpr int BQ = 32, BKV = 32, DC = 128, DNV_MAX = 64, kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ctx_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ content, T* __restrict__ out, int S, int NV, int DNV,
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
    const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) total[j] += o[j] * inv;
  }

  if (qi >= S) return;
  T* orow = out + (static_cast<long long>(b) * S + qi) * D + d0;
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
    if (d0 + c + 8 * j < D) orow[c + 8 * j] = from_f32<T>(total[j]);
}

template <typename T>
int launch_simt(const void* q, const void* k, const void* content, void* out, long long B,
                long long S, long long NV, long long DNV, long long D, long long q_sb,
                long long q_st, long long q_sh, long long k_sb, long long k_st, long long k_sh,
                long long c_sb, long long c_st, long long c_sh, float scale,
                cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((S + BQ - 1) / BQ),
                  static_cast<unsigned>((D + DC - 1) / DC), static_cast<unsigned>(B));
  fused_ctx_simt_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(content),
      static_cast<T*>(out), static_cast<int>(S), static_cast<int>(NV), static_cast<int>(DNV),
      static_cast<int>(D), q_sb, q_st, q_sh, k_sb, k_st, k_sh, c_sb, c_st, c_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc(const void* q, const void* k, const void* content, void* lse, void* out,
              long long B, long long S, long long NV, long long DNV, long long D, long long q_sb,
              long long q_st, long long q_sh, long long k_sb, long long k_st, long long k_sh,
              long long c_sb, long long c_st, long long c_sh, float scale, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ctx_pv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPvSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const dim3 lse_grid(static_cast<unsigned>((S + LQ - 1) / LQ), static_cast<unsigned>(NV),
                      static_cast<unsigned>(B));
  ctx_lse_kernel<<<lse_grid, kLseThreads, 0, stream>>>(
      qp, kp, static_cast<float*>(lse), static_cast<int>(S), static_cast<int>(NV),
      static_cast<int>(DNV), q_sb, q_st, q_sh, k_sb, k_st, k_sh, scale);
  const dim3 grid(static_cast<unsigned>((S + QR - 1) / QR),
                  static_cast<unsigned>((D + DS - 1) / DS), static_cast<unsigned>(B));
  ctx_pv_kernel<<<grid, kPvThreads, kPvSmem, stream>>>(
      qp, kp, static_cast<const __nv_bfloat16*>(content), static_cast<const float*>(lse),
      static_cast<__nv_bfloat16*>(out), static_cast<int>(S), static_cast<int>(NV),
      static_cast<int>(DNV), static_cast<int>(D), q_sb, q_st, q_sh, k_sb, k_st, k_sh, c_sb, c_st,
      c_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p, long long D, long long sb, long long st, long long sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && D % 8 == 0 && sb % 8 == 0 && st % 8 == 0 &&
         sh % 8 == 0;
}

}  // namespace

// lse: f32 workspace of B * NV * S elements (the tensor-core path's row
// log-sum-exps; unused by the SIMT path)
extern "C" int fused_contextualization_launch(const void* q, const void* k,
                                              const void* content, void* lse, void* out,
                                              long long B, long long S, long long NV,
                                              long long DNV, long long D, long long q_sb,
                                              long long q_st, long long q_sh, long long k_sb,
                                              long long k_st, long long k_sh, long long c_sb,
                                              long long c_st, long long c_sh, float scale,
                                              long long dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K4_ARGS q, k, content, out, B, S, NV, DNV, D, q_sb, q_st, q_sh, k_sb, k_st, k_sh, \
                c_sb, c_st, c_sh, scale, st
  if (dtype == DT_BF16) {
    const bool tc = aligned16(content, D, c_sb, c_st, c_sh) &&
                    aligned16(q, DNV, q_sb, q_st, q_sh) && aligned16(k, DNV, k_sb, k_st, k_sh);
    if (tc)
      return launch_tc(q, k, content, lse, out, B, S, NV, DNV, D, q_sb, q_st, q_sh, k_sb, k_st,
                       k_sh, c_sb, c_st, c_sh, scale, st);
    return launch_simt<__nv_bfloat16>(K4_ARGS);
  }
  if (dtype == DT_F32) return launch_simt<float>(K4_ARGS);
#undef K4_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
