// K5: FlashAttention backward (dq, dk, dv), with the dropout mask
// regenerated from its seed.
//
// Replaces the TPU kernel backpacks_flash_attn_tpu/ops/flash_attention.py
// _flash_bwd (:794): its default Pallas body _flash_bwd_scratch_kernel
// (:681), and the no-bias contract of _flash_bwd_fused_kernel (:590) and of
// the split _flash_bwd_dq_kernel (:460) + _flash_bwd_dkv_kernel (:523).
// Head dim 64, sq == sk, causal or not, bf16 or f32 in and out (as the TPU
// kernel takes both), f32 accumulators.
//
// The TPU kernel carries dq across a sequential grid in VMEM scratch; blocks
// on the card run in no order, so this is three launches with no atomics
// (deterministic):
// 1. delta_kernel: delta = rowsum(dO * O) per (b, h, row), one warp a row.
// 2. dkdv_kernel: one 128-thread block per (64-key tile, head, batch row);
//    each warp owns 16 keys. It walks the query tiles from the causal
//    diagonal, staging Q and dO (64 x 64 bf16 each) in shared memory, and
//    recomputes on tensor cores (mma.sync m16n8k16) S^T = K Q^T and
//    dP^T = V dO^T, then p = exp(scale * s - lse) with the forward's masks
//    and keep mask, dS = p * (dp - delta), and accumulates dV += P_drop^T dO
//    and dK += dS^T Q in registers, the probabilities turned into A
//    operands in registers (the FlashAttention-2 layout).
// 3. dq_kernel: one block per (64-query tile, head, batch row), walking the
//    key tiles up to the diagonal with the same recompute, dQ += dS K.
// f32 operands take SIMT versions of 2 and 3 (dkdv_simt_kernel,
// dq_simt_kernel): 32-row tiles of f32 in shared memory, 256 threads, eight
// threads a row, each making 4 of the row's 32 scores per tile and holding 8
// of its 64 gradient columns; every product in f32.
//
// Bound on the H100 at the training shape (32, 12, 512, 64) bf16: the
// bytes, about 8 tensors of 25 MB (q, k, v, out, dO read; dq, dk, dv
// written) = 0.06 ms, against ~16 GFLOP of the five causal products
// (0.016 ms). This first version recomputes the scores in both kernels (as
// the split TPU form does) and stages tiles synchronously; it is right
// first, fast later (cp.async/TMA rings, wgmma).
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int D = 64, T = 64, LD = D + 8, kThreads = kTileThreads;  // 144-byte smem rows

// ------------------------------------------------------------- 1. delta

template <typename E>
__global__ void __launch_bounds__(256)
delta_kernel(const E* __restrict__ out, const E* __restrict__ dout, float* __restrict__ delta,
             int B, int H, int S, Strides so, Strides sd) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(B) * S * H) return;
  const int h = static_cast<int>(row % H);
  const int i = static_cast<int>((row / H) % S);
  const int b = static_cast<int>(row / (static_cast<long long>(H) * S));
  const E* o = out + b * so.sb + i * so.st + h * so.sh + 2 * lane;
  const E* g = dout + b * sd.sb + i * sd.st + h * sd.sh + 2 * lane;
  float v = to_f32(o[0]) * to_f32(g[0]) + to_f32(o[1]) * to_f32(g[1]);
  v = warp_sum(v);
  if (lane == 0) delta[(static_cast<long long>(b) * H + h) * S + i] = v;
}

// ------------------------------------------------------------- helpers

__device__ __forceinline__ void store_rows(bf16* dst, long long row_stride, const float (&c)[D / 8][4],
                                           int r0, int g, int tq, int S, float mult) {
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

// ------------------------------------------------------------- 2. dk, dv

__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
            int S, Strides sq, Strides sk, Strides sv, Strides sd, float scale, int causal,
            DropoutParams drop) {
  __shared__ __align__(16) bf16 Qs[T][LD];
  __shared__ __align__(16) bf16 Ds[T][LD];
  __shared__ float Ls[T], Dl[T];
  const int k0 = blockIdx.x * T, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
  const int kr = warp * 16;  // the warp's first key within the tile
  const long long bh = static_cast<long long>(b) * H + h;
  const float sl2 = scale * kLog2e;

  // this block's K and V rows as A fragments (staged through Qs / Ds)
  load_tile<D>(&Qs[0][0], LD, k + b * sk.sb + h * sk.sh, sk.st, k0, S, 0, D);
  load_tile<D>(&Ds[0][0], LD, v + b * sv.sb + h * sv.sh, sv.st, k0, S, 0, D);
  __syncthreads();
  uint32_t ka[4][4], va[4][4];
  a_frags(ka, &Qs[0][0], LD, kr, g, tq);
  a_frags(va, &Ds[0][0], LD, kr, g, tq);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  const bf16* qb = q + b * sq.sb + h * sq.sh;
  const bf16* db = dout + b * sd.sb + h * sd.sh;
  for (int q0 = causal ? k0 : 0; q0 < S; q0 += T) {
    __syncthreads();  // the previous tiles (or K, V) are consumed
    load_tile<D>(&Qs[0][0], LD, qb, sq.st, q0, S, 0, D);
    load_tile<D>(&Ds[0][0], LD, db, sd.st, q0, S, 0, D);
    for (int i = threadIdx.x; i < T; i += kThreads) {
      const bool in = q0 + i < S;
      Ls[i] = in ? lse[bh * S + q0 + i] * kLog2e : 0.f;
      Dl[i] = in ? delta[bh * S + q0 + i] : 0.f;
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
          const bool valid = key < S && qry < S && (!causal || key <= qry);
          const float p = valid ? exp2f(st[nf][2 * half + e] * sl2 - Ls[ql]) : 0.f;
          float dp = dpt[nf][2 * half + e], pk = p;
          if (drop.on) {
            const bool keep = dropout_keep(drop, static_cast<uint32_t>(bh),
                                           static_cast<uint32_t>(qry), static_cast<uint32_t>(key));
            pk = keep ? p * drop.inv_keep : 0.f;
            dp = keep ? dp * drop.inv_keep : 0.f;
          }
          pv[e] = pk;
          ds[e] = p * (dp - Dl[ql]);
        }
        to_a(pa, nf, half, pv[0], pv[1]);
        to_a(dsa, nf, half, ds[0], ds[1]);
      }
    mma_ab<D / 8>(dv_acc, pa, &Ds[0][0], LD, lane);
    mma_ab<D / 8>(dk_acc, dsa, &Qs[0][0], LD, lane);
  }

  const long long o_st = static_cast<long long>(H) * D;
  store_rows(dk + (static_cast<long long>(b) * S * H + h) * D, o_st, dk_acc, k0 + kr, g, tq, S,
             scale);
  store_rows(dv + (static_cast<long long>(b) * S * H + h) * D, o_st, dv_acc, k0 + kr, g, tq, S,
             1.f);
}

// ------------------------------------------------------------- 3. dq

__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, bf16* __restrict__ dq, int H, int S, Strides sq,
          Strides sk, Strides sv, Strides sd, float scale, int causal, DropoutParams drop) {
  __shared__ __align__(16) bf16 Ks[T][LD];
  __shared__ __align__(16) bf16 Vs[T][LD];
  const int q0 = blockIdx.x * T, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
  const int qr = warp * 16;  // the warp's first query within the tile
  const long long bh = static_cast<long long>(b) * H + h;
  const float sl2 = scale * kLog2e;

  load_tile<D>(&Ks[0][0], LD, q + b * sq.sb + h * sq.sh, sq.st, q0, S, 0, D);
  load_tile<D>(&Vs[0][0], LD, dout + b * sd.sb + h * sd.sh, sd.st, q0, S, 0, D);
  __syncthreads();
  uint32_t qa[4][4], da[4][4];
  a_frags(qa, &Ks[0][0], LD, qr, g, tq);
  a_frags(da, &Vs[0][0], LD, qr, g, tq);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + qr + g + 8 * half;
    row_lse[half] = row < S ? lse[bh * S + row] * kLog2e : 0.f;
    row_delta[half] = row < S ? delta[bh * S + row] : 0.f;
  }

  float dq_acc[D / 8][4];
  zero(dq_acc);

  const bf16* kb = k + b * sk.sb + h * sk.sh;
  const bf16* vb = v + b * sv.sb + h * sv.sh;
  const int kv_end = causal ? min(S, q0 + T) : S;
  for (int j0 = 0; j0 < kv_end; j0 += T) {
    __syncthreads();
    load_tile<D>(&Ks[0][0], LD, kb, sk.st, j0, S, 0, D);
    load_tile<D>(&Vs[0][0], LD, vb, sv.st, j0, S, 0, D);
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
          const bool valid = key < S && qry < S && (!causal || key <= qry);
          const float p = valid ? exp2f(s[nf][2 * half + e] * sl2 - row_lse[half]) : 0.f;
          float dp = dps[nf][2 * half + e];
          if (drop.on)
            dp = dropout_keep(drop, static_cast<uint32_t>(bh), static_cast<uint32_t>(qry),
                              static_cast<uint32_t>(key))
                     ? dp * drop.inv_keep
                     : 0.f;
          ds[e] = p * (dp - row_delta[half]);
        }
        to_a(dsa, nf, half, ds[0], ds[1]);
      }
    mma_ab<D / 8>(dq_acc, dsa, &Ks[0][0], LD, lane);
  }
  store_rows(dq + (static_cast<long long>(b) * S * H + h) * D, static_cast<long long>(H) * D,
             dq_acc, q0 + qr, g, tq, S, scale);
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
// delta: f32 workspace of B * H * S; dq, dk, dv: contiguous (B, S, H, 64)
// outputs of the operands' dtype
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, long long B, long long H,
    long long S, long long q_sb, long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh, long long o_sb,
    long long o_st, long long o_sh, long long d_sb, long long d_st, long long d_sh, float scale,
    long long causal, long long seed0, long long seed1, long long thr, float inv_keep,
    long long dropout, long long dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutParams drop = make_dropout(seed0, seed1, thr, inv_keep, dropout);
  const Strides sq{q_sb, q_st, q_sh}, sk{k_sb, k_st, k_sh}, sv{v_sb, v_st, v_sh},
      so{o_sb, o_st, o_sh}, sd{d_sb, d_st, d_sh};
  const int b = static_cast<int>(B), h = static_cast<int>(H), s = static_cast<int>(S);
  const int c = static_cast<int>(causal);
  const auto* lp = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  const unsigned delta_blocks = static_cast<unsigned>((B * S * H + 7) / 8);
  if (dtype == DT_BF16) {
    const auto* qp = static_cast<const bf16*>(q);
    const auto* kp = static_cast<const bf16*>(k);
    const auto* vp = static_cast<const bf16*>(v);
    const auto* dp = static_cast<const bf16*>(dout);
    delta_kernel<bf16><<<delta_blocks, 256, 0, st>>>(static_cast<const bf16*>(out), dp, dl, b, h,
                                                     s, so, sd);
    const dim3 grid(static_cast<unsigned>((S + T - 1) / T), static_cast<unsigned>(H),
                    static_cast<unsigned>(B));
    dkdv_kernel<<<grid, kThreads, 0, st>>>(qp, kp, vp, dp, lp, dl, static_cast<bf16*>(dk),
                                           static_cast<bf16*>(dv), h, s, sq, sk, sv, sd, scale, c,
                                           drop);
    dq_kernel<<<grid, kThreads, 0, st>>>(qp, kp, vp, dp, lp, dl, static_cast<bf16*>(dq), h, s,
                                         sq, sk, sv, sd, scale, c, drop);
  } else if (dtype == DT_F32) {
    const auto* qp = static_cast<const float*>(q);
    const auto* kp = static_cast<const float*>(k);
    const auto* vp = static_cast<const float*>(v);
    const auto* dp = static_cast<const float*>(dout);
    delta_kernel<float><<<delta_blocks, 256, 0, st>>>(static_cast<const float*>(out), dp, dl, b,
                                                      h, s, so, sd);
    const dim3 grid(static_cast<unsigned>((S + ST - 1) / ST), static_cast<unsigned>(H),
                    static_cast<unsigned>(B));
    dkdv_simt_kernel<<<grid, kSimtThreads, 0, st>>>(qp, kp, vp, dp, lp, dl,
                                                    static_cast<float*>(dk),
                                                    static_cast<float*>(dv), h, s, sq, sk, sv, sd,
                                                    scale, c, drop);
    dq_simt_kernel<<<grid, kSimtThreads, 0, st>>>(qp, kp, vp, dp, lp, dl, static_cast<float*>(dq),
                                                  h, s, sq, sk, sv, sd, scale, c, drop);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
