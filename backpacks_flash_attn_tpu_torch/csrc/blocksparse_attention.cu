// K9: block-sparse FlashAttention, forward (out, LSE) and backward (dq;
// dk and dv), over only the (block_q, block_k) tiles a blockmask marks.
//
// Replaces the TPU kernels of backpacks_flash_attn_tpu/ops/flash_attention.py:
// the gathered forward _bs_fwd (:1185, Pallas body
// _blocksparse_gathered_kernel :1118) and the backward _bs_bwd_rule (:1362,
// _bs_bwd_dq_kernel :1242 and _bs_bwd_dkv_kernel :1284). The caller has
// scaled q (JAX :1439) and passes the active mask (n_qb, n_kb) int32 with
// the causal pre-filter applied (_bs_active :1175). Key u of sequence b is
// valid for query row i when its tile is active, u < min(seq_len[b], Sk)
// and, if causal, u <= i. A row with no valid key gives 0 and an LSE of
// FLASH_NEG_INF, as on the TPU.
//
// The TPU forward walks a scalar-prefetched table of active tiles and never
// DMAs an inactive one; here each block compacts its own blockmask row (the
// backward's dk/dv blocks their column) into a list in shared memory with a
// warp ballot, and loads only the K/V (or Q/dO) tiles of that list. The
// blockmask tiles (256 x 256 on the long-context path) split into the
// kernel's 64-row tiles; tiles wholly above the causal diagonal or past the
// keys' length are skipped, which changes nothing (their probabilities are
// 0). Three launches with no atomics, from one source:
// - forward: one 128-thread block per (64-query tile, head, batch row), a
//   warp per 16 rows, FlashAttention-2's loop: S = Q K^T and O += P V on
//   mma.sync m16n8k16 (bf16 in, f32 accumulators), the online softmax in
//   registers, P turned into A fragments in registers.
// - dq: one block per 64-query tile over its active key tiles, recomputing
//   p = exp(s - lse), dP = dO V^T, dS = p * (dp - delta), dQ += dS K.
// - dk/dv: one block per 64-key tile over the active query tiles of its
//   column, S^T and dP^T, dV += P^T dO, dK += dS^T Q.
// delta = rowsum(out * dO) is computed beside them in PyTorch, as JAX does
// in XLA. f32 operands take SIMT versions (K3's forward and K5's backward
// loops over the same lists).
//
// Bound on the H100 at the long-context shape (b 4, s 4096, h 12, d 64,
// band 1024 + global block 0): the operations of the active pairs, about
// 2 x 10^9 pairs x 256 (forward) or 640 (backward) flops, against ~25 MB a
// tensor of bytes: 0.5 and 1.3 ms at 989 TFLOP/s. This first version loads
// its tiles synchronously (no cp.async ring) and uses mma.sync, not wgmma;
// the forward's load balance follows the mask (rows with more active tiles
// take longer).
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int D = 64, T = 64, LD = D + 8, kThreads = kTileThreads;  // 144-byte smem rows
constexpr int kMaxBlocks = 512;  // blockmask blocks a row or column may have

// Compact the active entries act[base + i * step], i < n, in order into
// list (warp 0, one ballot per 32 entries); every thread gets the count.
__device__ int active_list(int* list, int* count, const int* __restrict__ act, int n,
                           long long base, long long step) {
  if (threadIdx.x < 32) {
    int total = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + static_cast<int>(threadIdx.x);
      const bool a = i < n && act[base + i * step] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, a);
      if (a) list[total + __popc(m & ((1u << threadIdx.x) - 1u))] = i;
      total += __popc(m);
    }
    if (threadIdx.x == 0) *count = total;
  }
  __syncthreads();
  return *count;
}

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

struct Shape {
  int H, Sq, Sk, n_qb, n_kb, block_q, block_k, causal;
  float scale;
};

// ------------------------------------------------------------- forward

__global__ void __launch_bounds__(kThreads)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           bf16* __restrict__ out, float* __restrict__ lse, const int* __restrict__ act,
           const int* __restrict__ seq_lengths, Shape sh, Strides sq, Strides sk, Strides sv) {
  __shared__ __align__(16) bf16 Ks[T][LD];
  __shared__ __align__(16) bf16 Vs[T][LD];
  __shared__ int list[kMaxBlocks];
  __shared__ int count;
  const int q0 = blockIdx.x * T, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
  const int qr = warp * 16;  // the warp's first query within the tile
  const int kv_len = min(seq_lengths[b], sh.Sk);
  const int n_act =
      active_list(list, &count, act, sh.n_kb, static_cast<long long>(q0 / sh.block_q) * sh.n_kb, 1);

  load_tile<D>(&Ks[0][0], LD, q + b * sq.sb + h * sq.sh, sq.st, q0, sh.Sq, 0, D);
  __syncthreads();
  uint32_t qa[4][4];
  a_frags(qa, &Ks[0][0], LD, qr, g, tq);

  float m[2] = {FLASH_NEG_INF, FLASH_NEG_INF}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
  zero(o);
  const bf16* kb = k + b * sk.sb + h * sk.sh;
  const bf16* vb = v + b * sv.sb + h * sv.sh;
  // keys past this bound are masked for every row of the tile
  const int kv_end = sh.causal ? min(kv_len, q0 + T) : kv_len;
  for (int i = 0; i < n_act; ++i) {
    const int j_lo = list[i] * sh.block_k, j_hi = min(j_lo + sh.block_k, kv_end);
    for (int j0 = j_lo; j0 < j_hi; j0 += T) {
      __syncthreads();  // Q's fragments taken; the previous tiles consumed
      load_tile<D>(&Ks[0][0], LD, kb, sk.st, j0, sh.Sk, 0, D);
      load_tile<D>(&Vs[0][0], LD, vb, sv.st, j0, sh.Sk, 0, D);
      __syncthreads();

      float s[T / 8][4];  // 16 queries x 64 keys
      zero(s);
      mma_abt(s, qa, &Ks[0][0], LD, 4, g, tq);
      uint32_t pa[T / 16][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = q0 + qr + g + 8 * half;
        float mx = FLASH_NEG_INF;
#pragma unroll
        for (int nf = 0; nf < T / 8; ++nf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = j0 + nf * 8 + 2 * tq + e;
            const bool valid = key < kv_len && (!sh.causal || key <= row);
            float& x = s[nf][2 * half + e];
            x = valid ? x * sh.scale : FLASH_NEG_INF;
            mx = fmaxf(mx, x);
          }
        mx = group_max(mx, 4);
        const float m_new = fmaxf(m[half], mx);
        const float corr = expf(m[half] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int nf = 0; nf < T / 8; ++nf) {
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = s[nf][2 * half + e];
            p[e] = x == FLASH_NEG_INF ? 0.f : exp2f((x - m_new) * kLog2e);
            rs += p[e];
          }
          to_a(pa, nf, half, p[0], p[1]);
          o[nf][2 * half] *= corr;
          o[nf][2 * half + 1] *= corr;
        }
        l[half] = l[half] * corr + group_sum(rs, 4);
        m[half] = m_new;
      }
      mma_ab<D / 8>(o, pa, &Vs[0][0], LD, lane);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + qr + g + 8 * half;
    if (row >= sh.Sq) continue;
    const float l_safe = l[half] == 0.f ? 1.f : l[half];
    const float inv = 1.f / l_safe;
    bf16* orow = out + ((static_cast<long long>(b) * sh.Sq + row) * sh.H + h) * D;
#pragma unroll
    for (int nf = 0; nf < D / 8; ++nf)
      *reinterpret_cast<__nv_bfloat162*>(orow + nf * 8 + 2 * tq) =
          __floats2bfloat162_rn(o[nf][2 * half] * inv, o[nf][2 * half + 1] * inv);
    if (tq == 0)
      lse[(static_cast<long long>(b) * sh.H + h) * sh.Sq + row] = m[half] + logf(l_safe);
  }
}

// f32: one 256-thread block per (64-query tile, head, batch row); four
// threads a row, each making 8 of its 32 scores per key tile and holding 16
// of its 64 output columns (K3's loop)
constexpr int BQ = 64, BKV = 32, kSimtThreads = 256;

__global__ void __launch_bounds__(kSimtThreads)
fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
                const int* __restrict__ act, const int* __restrict__ seq_lengths, Shape sh,
                Strides sq, Strides sk, Strides sv) {
  __shared__ float Qs[BQ][D + 1];
  __shared__ float Ks[BKV][D + 1];
  __shared__ float Vs[BKV][D];
  __shared__ float Ps[BQ][BKV + 1];
  __shared__ int list[kMaxBlocks];
  __shared__ int count;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3, qi = q0 + r;
  const int kv_len = min(seq_lengths[b], sh.Sk);
  const int n_act =
      active_list(list, &count, act, sh.n_kb, static_cast<long long>(q0 / sh.block_q) * sh.n_kb, 1);
  const float* qb = q + b * sq.sb + h * sq.sh;
  const float* kb = k + b * sk.sb + h * sk.sh;
  const float* vb = v + b * sv.sb + h * sv.sh;
  for (int idx = tid; idx < BQ * D; idx += kSimtThreads) {
    const int rr = idx / D, dd = idx % D;
    Qs[rr][dd] = q0 + rr < sh.Sq ? qb[(q0 + rr) * sq.st + dd] : 0.f;
  }
  const int kv_end = sh.causal ? min(kv_len, q0 + BQ) : kv_len;
  float m = FLASH_NEG_INF, l = 0.f;
  float o[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) o[j] = 0.f;

  for (int i = 0; i < n_act; ++i) {
    const int j_lo = list[i] * sh.block_k, j_hi = min(j_lo + sh.block_k, kv_end);
    for (int j0 = j_lo; j0 < j_hi; j0 += BKV) {
      __syncthreads();  // previous tile fully consumed (and Q staged)
      for (int idx = tid; idx < BKV * D; idx += kSimtThreads) {
        const int rr = idx / D, dd = idx % D;
        const bool in = j0 + rr < sh.Sk;
        Ks[rr][dd] = in ? kb[(j0 + rr) * sk.st + dd] : 0.f;
        Vs[rr][dd] = in ? vb[(j0 + rr) * sv.st + dd] : 0.f;
      }
      __syncthreads();
      float s[BKV / 4];
      float tile_max = FLASH_NEG_INF;
#pragma unroll
      for (int t = 0; t < BKV / 4; ++t) {
        const int kk = c + 4 * t, key = j0 + kk;
        float acc = 0.f;
#pragma unroll 16
        for (int dd = 0; dd < D; ++dd) acc += Qs[r][dd] * Ks[kk][dd];
        const bool valid = key < kv_len && (!sh.causal || key <= qi);
        s[t] = valid ? acc * sh.scale : FLASH_NEG_INF;
        tile_max = fmaxf(tile_max, s[t]);
      }
      const float m_new = fmaxf(m, group_max(tile_max, 4));
      const float corr = expf(m - m_new);
      float tile_sum = 0.f;
#pragma unroll
      for (int t = 0; t < BKV / 4; ++t) {
        const float p = s[t] == FLASH_NEG_INF ? 0.f : expf(s[t] - m_new);
        tile_sum += p;
        Ps[r][c + 4 * t] = p;
      }
      l = l * corr + group_sum(tile_sum, 4);
      m = m_new;
#pragma unroll
      for (int j = 0; j < D / 4; ++j) o[j] *= corr;
      __syncwarp();  // the row's four lanes share one warp
#pragma unroll 8
      for (int kk = 0; kk < BKV; ++kk) {
        const float p = Ps[r][kk];
#pragma unroll
        for (int j = 0; j < D / 4; ++j) o[j] += p * Vs[kk][c + 4 * j];
      }
    }
  }
  if (qi >= sh.Sq) return;
  const float l_safe = l == 0.f ? 1.f : l;
  const float inv = 1.f / l_safe;
  float* orow = out + ((static_cast<long long>(b) * sh.Sq + qi) * sh.H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 4; ++j) orow[c + 4 * j] = o[j] * inv;
  if (c == 0) lse[(static_cast<long long>(b) * sh.H + h) * sh.Sq + qi] = m + logf(l_safe);
}

// ------------------------------------------------------------- dq

__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, bf16* __restrict__ dq, const int* __restrict__ act,
          Shape sh, Strides sq, Strides sk, Strides sv, Strides sd) {
  __shared__ __align__(16) bf16 Ks[T][LD];
  __shared__ __align__(16) bf16 Vs[T][LD];
  __shared__ int list[kMaxBlocks];
  __shared__ int count;
  const int q0 = blockIdx.x * T, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
  const int qr = warp * 16;
  const long long bh = static_cast<long long>(b) * sh.H + h;
  const float sl2 = sh.scale * kLog2e;
  const int n_act =
      active_list(list, &count, act, sh.n_kb, static_cast<long long>(q0 / sh.block_q) * sh.n_kb, 1);

  load_tile<D>(&Ks[0][0], LD, q + b * sq.sb + h * sq.sh, sq.st, q0, sh.Sq, 0, D);
  load_tile<D>(&Vs[0][0], LD, dout + b * sd.sb + h * sd.sh, sd.st, q0, sh.Sq, 0, D);
  __syncthreads();
  uint32_t qa[4][4], da[4][4];
  a_frags(qa, &Ks[0][0], LD, qr, g, tq);
  a_frags(da, &Vs[0][0], LD, qr, g, tq);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + qr + g + 8 * half;
    row_lse[half] = row < sh.Sq ? lse[bh * sh.Sq + row] * kLog2e : 0.f;
    row_delta[half] = row < sh.Sq ? delta[bh * sh.Sq + row] : 0.f;
  }
  float dq_acc[D / 8][4];
  zero(dq_acc);

  const bf16* kb = k + b * sk.sb + h * sk.sh;
  const bf16* vb = v + b * sv.sb + h * sv.sh;
  const int kv_end = sh.causal ? min(sh.Sk, q0 + T) : sh.Sk;
  for (int i = 0; i < n_act; ++i) {
    const int j_lo = list[i] * sh.block_k, j_hi = min(j_lo + sh.block_k, kv_end);
    for (int j0 = j_lo; j0 < j_hi; j0 += T) {
      __syncthreads();
      load_tile<D>(&Ks[0][0], LD, kb, sk.st, j0, sh.Sk, 0, D);
      load_tile<D>(&Vs[0][0], LD, vb, sv.st, j0, sh.Sk, 0, D);
      __syncthreads();
      float s[T / 8][4], dps[T / 8][4];  // 16 queries x 64 keys
      zero(s);
      zero(dps);
      mma_abt(s, qa, &Ks[0][0], LD, 4, g, tq);
      mma_abt(dps, da, &Vs[0][0], LD, 4, g, tq);
      uint32_t dsa[T / 16][4];
#pragma unroll
      for (int nf = 0; nf < T / 8; ++nf)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qry = q0 + qr + g + 8 * half, key = j0 + nf * 8 + 2 * tq + e;
            const bool valid = key < sh.Sk && qry < sh.Sq && (!sh.causal || key <= qry);
            const float p = valid ? exp2f(s[nf][2 * half + e] * sl2 - row_lse[half]) : 0.f;
            ds[e] = p * (dps[nf][2 * half + e] - row_delta[half]);
          }
          to_a(dsa, nf, half, ds[0], ds[1]);
        }
      mma_ab<D / 8>(dq_acc, dsa, &Ks[0][0], LD, lane);
    }
  }
  store_rows(dq + (static_cast<long long>(b) * sh.Sq * sh.H + h) * D,
             static_cast<long long>(sh.H) * D, dq_acc, q0 + qr, g, tq, sh.Sq, sh.scale);
}

// ------------------------------------------------------------- dk, dv

__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
            const int* __restrict__ act, Shape sh, Strides sq, Strides sk, Strides sv,
            Strides sd) {
  __shared__ __align__(16) bf16 Qs[T][LD];
  __shared__ __align__(16) bf16 Ds[T][LD];
  __shared__ float Ls[T], Dl[T];
  __shared__ int list[kMaxBlocks];
  __shared__ int count;
  const int k0 = blockIdx.x * T, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
  const int kr = warp * 16;  // the warp's first key within the tile
  const long long bh = static_cast<long long>(b) * sh.H + h;
  const float sl2 = sh.scale * kLog2e;
  const int n_act = active_list(list, &count, act, sh.n_qb, k0 / sh.block_k, sh.n_kb);

  // this block's K and V rows as A fragments (staged through Qs / Ds)
  load_tile<D>(&Qs[0][0], LD, k + b * sk.sb + h * sk.sh, sk.st, k0, sh.Sk, 0, D);
  load_tile<D>(&Ds[0][0], LD, v + b * sv.sb + h * sv.sh, sv.st, k0, sh.Sk, 0, D);
  __syncthreads();
  uint32_t ka[4][4], va[4][4];
  a_frags(ka, &Qs[0][0], LD, kr, g, tq);
  a_frags(va, &Ds[0][0], LD, kr, g, tq);
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  const bf16* qb = q + b * sq.sb + h * sq.sh;
  const bf16* db = dout + b * sd.sb + h * sd.sh;
  for (int i = 0; i < n_act; ++i) {
    const int q_lo = list[i] * sh.block_q, q_hi = min(q_lo + sh.block_q, sh.Sq);
    // a query tile wholly below this key tile is causally masked
    for (int q0 = sh.causal ? max(q_lo, k0) : q_lo; q0 < q_hi; q0 += T) {
      __syncthreads();  // the previous tiles (or K, V) are consumed
      load_tile<D>(&Qs[0][0], LD, qb, sq.st, q0, sh.Sq, 0, D);
      load_tile<D>(&Ds[0][0], LD, db, sd.st, q0, sh.Sq, 0, D);
      for (int r = threadIdx.x; r < T; r += kThreads) {
        const bool in = q0 + r < sh.Sq;
        Ls[r] = in ? lse[bh * sh.Sq + q0 + r] * kLog2e : 0.f;
        Dl[r] = in ? delta[bh * sh.Sq + q0 + r] : 0.f;
      }
      __syncthreads();
      float st[T / 8][4], dpt[T / 8][4];  // 16 keys x 64 queries
      zero(st);
      zero(dpt);
      mma_abt(st, ka, &Qs[0][0], LD, 4, g, tq);
      mma_abt(dpt, va, &Ds[0][0], LD, 4, g, tq);
      uint32_t pa[T / 16][4], dsa[T / 16][4];
#pragma unroll
      for (int nf = 0; nf < T / 8; ++nf)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float pv[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + kr + g + 8 * half, ql = nf * 8 + 2 * tq + e, qry = q0 + ql;
            const bool valid = key < sh.Sk && qry < sh.Sq && (!sh.causal || key <= qry);
            const float p = valid ? exp2f(st[nf][2 * half + e] * sl2 - Ls[ql]) : 0.f;
            pv[e] = p;
            ds[e] = p * (dpt[nf][2 * half + e] - Dl[ql]);
          }
          to_a(pa, nf, half, pv[0], pv[1]);
          to_a(dsa, nf, half, ds[0], ds[1]);
        }
      mma_ab<D / 8>(dv_acc, pa, &Ds[0][0], LD, lane);
      mma_ab<D / 8>(dk_acc, dsa, &Qs[0][0], LD, lane);
    }
  }
  const long long o_st = static_cast<long long>(sh.H) * D;
  store_rows(dk + (static_cast<long long>(b) * sh.Sk * sh.H + h) * D, o_st, dk_acc, k0 + kr, g,
             tq, sh.Sk, sh.scale);
  store_rows(dv + (static_cast<long long>(b) * sh.Sk * sh.H + h) * D, o_st, dv_acc, k0 + kr, g,
             tq, sh.Sk, 1.f);
}

// ------------------------------------------------------------- backward, f32 (SIMT)

constexpr int ST = 32, SLD = D + 1;

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

// one block per (32-query tile, head, batch row); thread (r, c) = query
// q0 + r, keys c + 8 i of each tile, gradient columns c + 8 j
__global__ void __launch_bounds__(kSimtThreads)
dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, const int* __restrict__ act, Shape sh, Strides sq,
               Strides sk, Strides sv, Strides sd) {
  __shared__ float Qs[ST][SLD], Ds[ST][SLD], Ks[ST][SLD], Vs[ST][SLD];
  __shared__ float DSs[ST][ST + 1];
  __shared__ int list[kMaxBlocks];
  __shared__ int count;
  const int q0 = blockIdx.x * ST, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7, qry = q0 + r;
  const long long bh = static_cast<long long>(b) * sh.H + h;
  const int n_act =
      active_list(list, &count, act, sh.n_kb, static_cast<long long>(q0 / sh.block_q) * sh.n_kb, 1);
  load_rows(Qs, q + b * sq.sb + h * sq.sh, sq.st, q0, sh.Sq);
  load_rows(Ds, dout + b * sd.sb + h * sd.sh, sd.st, q0, sh.Sq);
  const float row_lse = qry < sh.Sq ? lse[bh * sh.Sq + qry] : 0.f;
  const float row_delta = qry < sh.Sq ? delta[bh * sh.Sq + qry] : 0.f;
  float dq_acc[D / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq_acc[j] = 0.f;

  const float* kb = k + b * sk.sb + h * sk.sh;
  const float* vb = v + b * sv.sb + h * sv.sh;
  const int kv_end = sh.causal ? min(sh.Sk, q0 + ST) : sh.Sk;
  for (int i = 0; i < n_act; ++i) {
    const int j_lo = list[i] * sh.block_k, j_hi = min(j_lo + sh.block_k, kv_end);
    for (int j0 = j_lo; j0 < j_hi; j0 += ST) {
      __syncthreads();
      load_rows(Ks, kb, sk.st, j0, sh.Sk);
      load_rows(Vs, vb, sv.st, j0, sh.Sk);
      __syncthreads();
#pragma unroll
      for (int t = 0; t < ST / 8; ++t) {
        const int kl = c + 8 * t, key = j0 + kl;
        const bool valid = key < sh.Sk && qry < sh.Sq && (!sh.causal || key <= qry);
        const float p = valid ? expf(dot64(Qs[r], Ks[kl]) * sh.scale - row_lse) : 0.f;
        DSs[r][kl] = p * (dot64(Ds[r], Vs[kl]) - row_delta);
      }
      __syncwarp();
      for (int kl = 0; kl < ST; ++kl) {
        const float ds = DSs[r][kl];
#pragma unroll
        for (int j = 0; j < D / 8; ++j) dq_acc[j] += ds * Ks[kl][c + 8 * j];
      }
    }
  }
  if (qry >= sh.Sq) return;
  float* drow = dq + ((static_cast<long long>(b) * sh.Sq + qry) * sh.H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) drow[c + 8 * j] = dq_acc[j] * sh.scale;
}

// one block per (32-key tile, head, batch row); thread (r, c) = key k0 + r,
// queries c + 8 i of each tile, gradient columns c + 8 j
__global__ void __launch_bounds__(kSimtThreads)
dkdv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, const int* __restrict__ act,
                 Shape sh, Strides sq, Strides sk, Strides sv, Strides sd) {
  __shared__ float Ks[ST][SLD], Vs[ST][SLD], Qs[ST][SLD], Ds[ST][SLD];
  __shared__ float Ps[ST][ST + 1], DSs[ST][ST + 1];
  __shared__ float Ls[ST], Dl[ST];
  __shared__ int list[kMaxBlocks];
  __shared__ int count;
  const int k0 = blockIdx.x * ST, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7, key = k0 + r;
  const long long bh = static_cast<long long>(b) * sh.H + h;
  const int n_act = active_list(list, &count, act, sh.n_qb, k0 / sh.block_k, sh.n_kb);
  load_rows(Ks, k + b * sk.sb + h * sk.sh, sk.st, k0, sh.Sk);
  load_rows(Vs, v + b * sv.sb + h * sv.sh, sv.st, k0, sh.Sk);
  float dk_acc[D / 8], dv_acc[D / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  const float* qb = q + b * sq.sb + h * sq.sh;
  const float* db = dout + b * sd.sb + h * sd.sh;
  for (int i = 0; i < n_act; ++i) {
    const int q_lo = list[i] * sh.block_q, q_hi = min(q_lo + sh.block_q, sh.Sq);
    for (int q0 = sh.causal ? max(q_lo, k0) : q_lo; q0 < q_hi; q0 += ST) {
      __syncthreads();  // the previous tiles are consumed (and K, V staged)
      load_rows(Qs, qb, sq.st, q0, sh.Sq);
      load_rows(Ds, db, sd.st, q0, sh.Sq);
      for (int t = threadIdx.x; t < ST; t += kSimtThreads) {
        const bool in = q0 + t < sh.Sq;
        Ls[t] = in ? lse[bh * sh.Sq + q0 + t] : 0.f;
        Dl[t] = in ? delta[bh * sh.Sq + q0 + t] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int t = 0; t < ST / 8; ++t) {
        const int ql = c + 8 * t, qry = q0 + ql;
        const bool valid = key < sh.Sk && qry < sh.Sq && (!sh.causal || key <= qry);
        const float p = valid ? expf(dot64(Ks[r], Qs[ql]) * sh.scale - Ls[ql]) : 0.f;
        Ps[r][ql] = p;
        DSs[r][ql] = p * (dot64(Vs[r], Ds[ql]) - Dl[ql]);
      }
      __syncwarp();  // the row's eight threads share one warp
      for (int ql = 0; ql < ST; ++ql) {
        const float p = Ps[r][ql], ds = DSs[r][ql];
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          dv_acc[j] += p * Ds[ql][c + 8 * j];
          dk_acc[j] += ds * Qs[ql][c + 8 * j];
        }
      }
    }
  }
  if (key >= sh.Sk) return;
  const long long o = ((static_cast<long long>(b) * sh.Sk + key) * sh.H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk[o + c + 8 * j] = dk_acc[j] * sh.scale;
    dv[o + c + 8 * j] = dv_acc[j];
  }
}

Shape make_shape(long long H, long long sq, long long sk, long long n_qb, long long n_kb,
                 long long block_q, long long block_k, long long causal, float scale) {
  return Shape{static_cast<int>(H),       static_cast<int>(sq),      static_cast<int>(sk),
               static_cast<int>(n_qb),    static_cast<int>(n_kb),    static_cast<int>(block_q),
               static_cast<int>(block_k), static_cast<int>(causal), scale};
}

bool bad_shape(long long n_qb, long long n_kb, long long block_q, long long block_k) {
  return n_qb > kMaxBlocks || n_kb > kMaxBlocks || block_q % T || block_k % T || block_q <= 0 ||
         block_k <= 0;
}

dim3 grid_of(long long rows, int tile, long long H, long long B) {
  return dim3(static_cast<unsigned>((rows + tile - 1) / tile), static_cast<unsigned>(H),
              static_cast<unsigned>(B));
}

}  // namespace

// q (B, sq, H, 64), k and v (B, sk, H, 64), bf16 or f32 (dtype) with the
// given (batch, row, head) strides, bf16 rows 16-byte aligned; act
// (n_qb, n_kb) int32, the active tiles; seq_lengths (B,) int32 -> out
// (B, sq, H, 64) contiguous, lse (B, H, sq) f32
extern "C" int blocksparse_fwd_launch(const void* q, const void* k, const void* v, void* out,
                                      void* lse, const void* act, const void* seq_lengths,
                                      long long B, long long H, long long sq, long long sk,
                                      long long n_qb, long long n_kb, long long block_q,
                                      long long block_k, long long q_sb, long long q_st,
                                      long long q_sh, long long k_sb, long long k_st,
                                      long long k_sh, long long v_sb, long long v_st,
                                      long long v_sh, float scale, long long causal,
                                      long long dtype, void* stream) {
  if (bad_shape(n_qb, n_kb, block_q, block_k)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Shape sh = make_shape(H, sq, sk, n_qb, n_kb, block_q, block_k, causal, scale);
  const Strides sq_{q_sb, q_st, q_sh}, sk_{k_sb, k_st, k_sh}, sv_{v_sb, v_st, v_sh};
  const auto* ap = static_cast<const int*>(act);
  const auto* lp = static_cast<const int*>(seq_lengths);
  if (dtype == DT_BF16) {
    fwd_kernel<<<grid_of(sq, T, H, B), kThreads, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), static_cast<float*>(lse), ap, lp, sh, sq_, sk_, sv_);
  } else if (dtype == DT_F32) {
    fwd_simt_kernel<<<grid_of(sq, BQ, H, B), kSimtThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(out), static_cast<float*>(lse), ap, lp, sh, sq_, sk_, sv_);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q, dout (B, sq, H, 64), k, v (B, sk, H, 64) with the given strides; lse
// and delta (B, H, sq) f32 contiguous; act as the forward's -> dq
// (B, sq, H, 64) contiguous
extern "C" int blocksparse_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, const void* act, long long B, long long H, long long sq,
    long long sk, long long n_qb, long long n_kb, long long block_q, long long block_k,
    long long q_sb, long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh, long long d_sb,
    long long d_st, long long d_sh, float scale, long long causal, long long dtype,
    void* stream) {
  if (bad_shape(n_qb, n_kb, block_q, block_k)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Shape sh = make_shape(H, sq, sk, n_qb, n_kb, block_q, block_k, causal, scale);
  const Strides sq_{q_sb, q_st, q_sh}, sk_{k_sb, k_st, k_sh}, sv_{v_sb, v_st, v_sh},
      sd_{d_sb, d_st, d_sh};
  const auto* lp = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  const auto* ap = static_cast<const int*>(act);
  if (dtype == DT_BF16) {
    dq_kernel<<<grid_of(sq, T, H, B), kThreads, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lp, dl, static_cast<bf16*>(dq), ap, sh, sq_, sk_, sv_,
        sd_);
  } else if (dtype == DT_F32) {
    dq_simt_kernel<<<grid_of(sq, ST, H, B), kSimtThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lp, dl, static_cast<float*>(dq), ap, sh, sq_, sk_, sv_,
        sd_);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// as blocksparse_bwd_dq_launch -> dk, dv (B, sk, H, 64) contiguous
extern "C" int blocksparse_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, const void* act, long long B, long long H,
    long long sq, long long sk, long long n_qb, long long n_kb, long long block_q,
    long long block_k, long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long d_sb, long long d_st, long long d_sh, float scale, long long causal,
    long long dtype, void* stream) {
  if (bad_shape(n_qb, n_kb, block_q, block_k)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Shape sh = make_shape(H, sq, sk, n_qb, n_kb, block_q, block_k, causal, scale);
  const Strides sq_{q_sb, q_st, q_sh}, sk_{k_sb, k_st, k_sh}, sv_{v_sb, v_st, v_sh},
      sd_{d_sb, d_st, d_sh};
  const auto* lp = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  const auto* ap = static_cast<const int*>(act);
  if (dtype == DT_BF16) {
    dkdv_kernel<<<grid_of(sk, T, H, B), kThreads, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lp, dl, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        ap, sh, sq_, sk_, sv_, sd_);
  } else if (dtype == DT_F32) {
    dkdv_simt_kernel<<<grid_of(sk, ST, H, B), kSimtThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lp, dl, static_cast<float*>(dk), static_cast<float*>(dv),
        ap, sh, sq_, sk_, sv_, sd_);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
