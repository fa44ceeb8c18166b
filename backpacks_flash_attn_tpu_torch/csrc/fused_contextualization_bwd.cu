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
//   delta_k[t] = sum_j alpha (dP - 0)             (= dO[t] . O_k[t])
//   dS         = alpha * (dP - delta_k[t])
//   dq = scale dS k,  dk = scale dS^T q,  dc_k = alpha^T dO.
// Nothing of alpha or of the per-head outputs is stored.
//
// What sets the design: the 768-wide content row. A dk/dc block cannot hold
// a 64 x 768 f32 accumulator, and dP needs the whole row. So three
// launches, all mma.sync m16n8k16 bf16 with f32 accumulators, 128 threads
// (4 warps x 16 rows), 64 x 64 tiles staged in shared memory:
// 1. dq_kernel, one block per (64-query tile, head, batch row): pass 1
//    over the causal key tiles accumulates delta (dP streamed over d in
//    64-column chunks); pass 2 recomputes dP and adds dS k into dq. Writes
//    dq and delta. (Two passes, as on the TPU: a one-pass dq = sum(alpha dP
//    k) - delta sum(alpha k) rounds alpha dP to bf16 before the
//    cancellation.)
// 2. dk_kernel, one block per (64-key tile, head, batch row): over the
//    query tiles from the diagonal, dP^T = c dO^T (streamed over d) and
//    dk += dS^T q. dk gets this pass of its own so that dP is computed once
//    per key tile.
// 3. dc_kernel, one block per (64-key tile, 128-column slab of d, head,
//    batch row): dc += alpha^T dO[:, slab], the 48-wide scores recomputed
//    per slab (as K4's PV kernel does).
//
// Bound on the H100 at (32, 512), nv 16, dnv 48, d 768: each of the three
// d-wide products (dP, dP again for dk, alpha^T dO) is ~100 GFLOP over the
// causal pairs, ~0.3 ms by operations; reading q/k/content/dO and writing
// the gradients is ~0.5 GB, ~0.15 ms by bytes. This first version makes
// four d-wide products (dP twice in dq_kernel) and stages tiles
// synchronously: right first, fast later.
// bf16 needs 16-byte aligned rows, dnv % 8 == 0, dnv <= 64, d % 8 == 0.
// f32 operands (dnv <= 64, any d) take SIMT versions of the same three
// launches: 32-row tiles of f32 in shared memory, 256 threads, eight
// threads a row, each making 4 of the row's 32 scores per tile; dP streams
// over d in 64-column chunks and dcontent takes 128-column slabs, as above.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int T = 64, LD = 64 + 8, SLAB = 128, SLD = SLAB + 8, kThreads = kTileThreads;

// c += X Y^T over the whole d: X = 64 rows of x (the warp's 16 as A), Y =
// 64 rows of y, both streamed through 64-column chunks in shared memory
__device__ __forceinline__ void dot_rows(float (&c)[8][4], bf16 (*xs)[LD], bf16 (*ys)[LD],
                                         const bf16* xb, long long x_st, int x0, const bf16* yb,
                                         long long y_st, int y0, int S, int D, int r0, int g,
                                         int tq) {
  for (int d0 = 0; d0 < D; d0 += 64) {
    __syncthreads();
    load_tile<64>(&xs[0][0], LD, xb, x_st, x0, S, d0, D);
    load_tile<64>(&ys[0][0], LD, yb, y_st, y0, S, d0, D);
    __syncthreads();
    uint32_t xa[4][4];
    a_frags(xa, &xs[0][0], LD, r0, g, tq);
    mma_abt(c, xa, &ys[0][0], LD, 4, g, tq);
  }
}

// ------------------------------------------------------------- 1. dq, delta

__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ c,
          const bf16* __restrict__ g_out, const float* __restrict__ lse, float* __restrict__ delta,
          bf16* __restrict__ dq, int S, int NV, int DNV, int D, Strides sq, Strides sk,
          Strides sc, long long g_sb, long long g_st, float scale) {
  __shared__ __align__(16) bf16 Qt[T][LD];
  __shared__ __align__(16) bf16 Kt[T][LD];
  __shared__ __align__(16) bf16 Ot[T][LD];
  __shared__ __align__(16) bf16 Ct[T][LD];
  const int q0 = blockIdx.x * T, head = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;
  const int ksteps = (DNV + 15) / 16;
  const long long bh = static_cast<long long>(b) * NV + head;
  const float sl2 = scale * kLog2e;
  const bf16* qb = q + b * sq.sb + head * sq.sh;
  const bf16* kb = k + b * sk.sb + head * sk.sh;
  const bf16* cb = c + b * sc.sb + head * sc.sh;
  const bf16* gb = g_out + b * g_sb;

  load_tile<64>(&Qt[0][0], LD, qb, sq.st, q0, S, 0, DNV);
  __syncthreads();
  uint32_t qa[4][4];
  a_frags(qa, &Qt[0][0], LD, r0, g, tq);
  float row_lse[2], row_delta[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + g + 8 * half;
    row_lse[half] = row < S ? lse[bh * S + row] * kLog2e : 0.f;
  }
  float dq_acc[8][4];
  zero(dq_acc);

  const int kv_end = min(S, q0 + T);
  for (int pass = 0; pass < 2; ++pass) {
    for (int j0 = 0; j0 < kv_end; j0 += T) {
      __syncthreads();
      load_tile<64>(&Kt[0][0], LD, kb, sk.st, j0, S, 0, DNV);
      float s[8][4], dp[8][4];
      zero(s);
      zero(dp);
      dot_rows(dp, Ot, Ct, gb, g_st, q0, cb, sc.st, j0, S, D, r0, g, tq);  // syncs: Kt ready
      mma_abt(s, qa, &Kt[0][0], LD, ksteps, g, tq);
      uint32_t dsa[4][4];
#pragma unroll
      for (int nf = 0; nf < 8; ++nf)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = q0 + r0 + g + 8 * half, key = j0 + nf * 8 + 2 * tq + e;
            const bool valid = row < S && key < S && key <= row;
            const float a = valid ? exp2f(s[nf][2 * half + e] * sl2 - row_lse[half]) : 0.f;
            const float d = dp[nf][2 * half + e];
            if (pass == 0) row_delta[half] += a * d;
            ds[e] = a * (d - row_delta[half]);
          }
          if (pass == 1) to_a(dsa, nf, half, ds[0], ds[1]);
        }
      if (pass == 1) mma_ab<8>(dq_acc, dsa, &Kt[0][0], LD, lane);
    }
    if (pass == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        row_delta[half] = group_sum(row_delta[half], 4);
        const int row = q0 + r0 + g + 8 * half;
        if (tq == 0 && row < S) delta[bh * S + row] = row_delta[half];
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + g + 8 * half;
    if (row >= S) continue;
    bf16* drow = dq + ((static_cast<long long>(b) * S + row) * NV + head) * DNV;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = ni * 8 + 2 * tq;
      if (col < DNV)
        *reinterpret_cast<__nv_bfloat162*>(drow + col) = __floats2bfloat162_rn(
            dq_acc[ni][2 * half] * scale, dq_acc[ni][2 * half + 1] * scale);
    }
  }
}

// ------------------------------------------------------------- 2. dk

__global__ void __launch_bounds__(kThreads)
dk_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ c,
          const bf16* __restrict__ g_out, const float* __restrict__ lse,
          const float* __restrict__ delta, bf16* __restrict__ dk, int S, int NV, int DNV, int D,
          Strides sq, Strides sk, Strides sc, long long g_sb, long long g_st, float scale) {
  __shared__ __align__(16) bf16 Qt[T][LD];
  __shared__ __align__(16) bf16 Ot[T][LD];
  __shared__ __align__(16) bf16 Ct[T][LD];
  __shared__ float Ls[T], Dl[T];
  const int k0 = blockIdx.x * T, head = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
  const int kr = warp * 16;
  const int ksteps = (DNV + 15) / 16;
  const long long bh = static_cast<long long>(b) * NV + head;
  const float sl2 = scale * kLog2e;
  const bf16* qb = q + b * sq.sb + head * sq.sh;
  const bf16* cb = c + b * sc.sb + head * sc.sh;
  const bf16* gb = g_out + b * g_sb;

  load_tile<64>(&Ct[0][0], LD, k + b * sk.sb + head * sk.sh, sk.st, k0, S, 0, DNV);
  __syncthreads();
  uint32_t ka[4][4];
  a_frags(ka, &Ct[0][0], LD, kr, g, tq);
  float dk_acc[8][4];
  zero(dk_acc);

  for (int q0 = k0; q0 < S; q0 += T) {
    __syncthreads();
    load_tile<64>(&Qt[0][0], LD, qb, sq.st, q0, S, 0, DNV);
    for (int i = threadIdx.x; i < T; i += kThreads) {
      const bool in = q0 + i < S;
      Ls[i] = in ? lse[bh * S + q0 + i] * kLog2e : 0.f;
      Dl[i] = in ? delta[bh * S + q0 + i] : 0.f;
    }
    float st[8][4], dpt[8][4];  // 16 keys x 64 queries
    zero(st);
    zero(dpt);
    dot_rows(dpt, Ct, Ot, cb, sc.st, k0, gb, g_st, q0, S, D, kr, g, tq);  // syncs: Qt ready
    mma_abt(st, ka, &Qt[0][0], LD, ksteps, g, tq);
    uint32_t dsa[4][4];
#pragma unroll
    for (int nf = 0; nf < 8; ++nf)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + kr + g + 8 * half, ql = nf * 8 + 2 * tq + e, qry = q0 + ql;
          const bool valid = key < S && qry < S && key <= qry;
          const float a = valid ? exp2f(st[nf][2 * half + e] * sl2 - Ls[ql]) : 0.f;
          ds[e] = a * (dpt[nf][2 * half + e] - Dl[ql]);
        }
        to_a(dsa, nf, half, ds[0], ds[1]);
      }
    mma_ab<8>(dk_acc, dsa, &Qt[0][0], LD, lane);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + kr + g + 8 * half;
    if (key >= S) continue;
    bf16* drow = dk + ((static_cast<long long>(b) * S + key) * NV + head) * DNV;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = ni * 8 + 2 * tq;
      if (col < DNV)
        *reinterpret_cast<__nv_bfloat162*>(drow + col) = __floats2bfloat162_rn(
            dk_acc[ni][2 * half] * scale, dk_acc[ni][2 * half + 1] * scale);
    }
  }
}

// ------------------------------------------------------------- 3. dcontent

__global__ void __launch_bounds__(kThreads)
dc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ g_out,
          const float* __restrict__ lse, bf16* __restrict__ dc, int S, int NV, int DNV, int D,
          int n_slabs, Strides sq, Strides sk, long long g_sb, long long g_st, float scale) {
  __shared__ __align__(16) bf16 Qt[T][LD];
  __shared__ __align__(16) bf16 Os[T][SLD];
  __shared__ float Ls[T];
  const int k0 = blockIdx.x * T, head = blockIdx.y / n_slabs, b = blockIdx.z;
  const int d0 = (blockIdx.y % n_slabs) * SLAB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
  const int kr = warp * 16;
  const int ksteps = (DNV + 15) / 16;
  const long long bh = static_cast<long long>(b) * NV + head;
  const float sl2 = scale * kLog2e;
  const bf16* qb = q + b * sq.sb + head * sq.sh;
  const bf16* gb = g_out + b * g_sb;

  load_tile<64>(&Qt[0][0], LD, k + b * sk.sb + head * sk.sh, sk.st, k0, S, 0, DNV);
  __syncthreads();
  uint32_t ka[4][4];
  a_frags(ka, &Qt[0][0], LD, kr, g, tq);
  float dc_acc[SLAB / 8][4];
  zero(dc_acc);

  for (int q0 = k0; q0 < S; q0 += T) {
    __syncthreads();
    load_tile<64>(&Qt[0][0], LD, qb, sq.st, q0, S, 0, DNV);
    load_tile<SLAB>(&Os[0][0], SLD, gb, g_st, q0, S, d0, D);
    for (int i = threadIdx.x; i < T; i += kThreads)
      Ls[i] = q0 + i < S ? lse[bh * S + q0 + i] * kLog2e : 0.f;
    __syncthreads();
    float st[8][4];
    zero(st);
    mma_abt(st, ka, &Qt[0][0], LD, ksteps, g, tq);
    uint32_t pa[4][4];
#pragma unroll
    for (int nf = 0; nf < 8; ++nf)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + kr + g + 8 * half, ql = nf * 8 + 2 * tq + e, qry = q0 + ql;
          const bool valid = key < S && qry < S && key <= qry;
          p[e] = valid ? exp2f(st[nf][2 * half + e] * sl2 - Ls[ql]) : 0.f;
        }
        to_a(pa, nf, half, p[0], p[1]);
      }
    mma_ab<SLAB / 8>(dc_acc, pa, &Os[0][0], SLD, lane);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + kr + g + 8 * half;
    if (key >= S) continue;
    bf16* drow = dc + ((static_cast<long long>(b) * S + key) * NV + head) * D;
#pragma unroll
    for (int ni = 0; ni < SLAB / 8; ++ni) {
      const int col = d0 + ni * 8 + 2 * tq;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(drow + col) =
            __floats2bfloat162_rn(dc_acc[ni][2 * half], dc_acc[ni][2 * half + 1]);
    }
  }
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
// all f32 (dtype), with the given strides (bf16 rows 16-byte aligned); lse
// (B, NV, S) f32 from the forward; delta: f32 workspace of B * NV * S; dq,
// dk (B, S, NV, DNV) and dc (B, S, NV, D): contiguous outputs of the
// operands' dtype
extern "C" int fused_contextualization_bwd_launch(
    const void* q, const void* k, const void* content, const void* g, const void* lse,
    void* delta, void* dq, void* dk, void* dc, long long B, long long S, long long NV,
    long long DNV, long long D, long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long c_sb, long long c_st, long long c_sh,
    long long g_sb, long long g_st, float scale, long long dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sq{q_sb, q_st, q_sh}, sk{k_sb, k_st, k_sh}, sc{c_sb, c_st, c_sh};
  const auto* lp = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  const int s = static_cast<int>(S), nv = static_cast<int>(NV), dnv = static_cast<int>(DNV),
            d = static_cast<int>(D);
  if (dtype == DT_BF16) {
    const auto* qp = static_cast<const bf16*>(q);
    const auto* kp = static_cast<const bf16*>(k);
    const auto* cp = static_cast<const bf16*>(content);
    const auto* gp = static_cast<const bf16*>(g);
    const unsigned tiles = static_cast<unsigned>((S + T - 1) / T);
    const dim3 grid(tiles, static_cast<unsigned>(NV), static_cast<unsigned>(B));
    dq_kernel<<<grid, kThreads, 0, st>>>(qp, kp, cp, gp, lp, dl, static_cast<bf16*>(dq), s, nv,
                                         dnv, d, sq, sk, sc, g_sb, g_st, scale);
    dk_kernel<<<grid, kThreads, 0, st>>>(qp, kp, cp, gp, lp, dl, static_cast<bf16*>(dk), s, nv,
                                         dnv, d, sq, sk, sc, g_sb, g_st, scale);
    const int n_slabs = static_cast<int>((D + SLAB - 1) / SLAB);
    const dim3 dc_grid(tiles, static_cast<unsigned>(NV * n_slabs), static_cast<unsigned>(B));
    dc_kernel<<<dc_grid, kThreads, 0, st>>>(qp, kp, gp, lp, static_cast<bf16*>(dc), s, nv, dnv,
                                            d, n_slabs, sq, sk, g_sb, g_st, scale);
  } else if (dtype == DT_F32) {
    const auto* qp = static_cast<const float*>(q);
    const auto* kp = static_cast<const float*>(k);
    const auto* cp = static_cast<const float*>(content);
    const auto* gp = static_cast<const float*>(g);
    const unsigned tiles = static_cast<unsigned>((S + ST - 1) / ST);
    const dim3 grid(tiles, static_cast<unsigned>(NV), static_cast<unsigned>(B));
    dq_simt_kernel<<<grid, kSimtThreads, 0, st>>>(qp, kp, cp, gp, lp, dl,
                                                  static_cast<float*>(dq), s, nv, dnv, d, sq, sk,
                                                  sc, g_sb, g_st, scale);
    dk_simt_kernel<<<grid, kSimtThreads, 0, st>>>(qp, kp, cp, gp, lp, dl,
                                                  static_cast<float*>(dk), s, nv, dnv, d, sq, sk,
                                                  sc, g_sb, g_st, scale);
    const int n_slabs = static_cast<int>((D + FSLAB - 1) / FSLAB);
    const dim3 dc_grid(tiles, static_cast<unsigned>(NV * n_slabs), static_cast<unsigned>(B));
    dc_simt_kernel<<<dc_grid, kSimtThreads, 0, st>>>(qp, kp, gp, lp, static_cast<float*>(dc), s,
                                                     nv, dnv, d, n_slabs, sq, sk, g_sb, g_st,
                                                     scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
