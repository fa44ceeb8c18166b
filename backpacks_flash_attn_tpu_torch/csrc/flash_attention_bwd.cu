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
// ensures) is three launches from one C entry, whose kernels live in
// flash_attention_bwd.cuh (K9's backward runs them over its own walk of
// the query tiles):
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
#include "flash_attention_bwd.cuh"

namespace {

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
  const int h = static_cast<int>(H), s = static_cast<int>(S);
  const int c = static_cast<int>(causal);
  const auto* lp = static_cast<const float*>(lse);
  auto* wp = static_cast<float*>(ws);
  if (dtype == DT_BF16) {
    BwdArgs a{};
    a.q = static_cast<const bf16*>(q);
    a.k = static_cast<const bf16*>(k);
    a.v = static_cast<const bf16*>(v);
    a.dout = static_cast<const bf16*>(dout);
    a.dk = static_cast<bf16*>(dk);
    a.dv = static_cast<bf16*>(dv);
    a.H = h;
    a.Sq = a.Sk = s;
    a.causal = c;
    a.sq = sq;
    a.sk = sk;
    a.sv = sv;
    a.sd = sd;
    a.scale = scale;
    a.drop = drop;
    const cudaError_t err =
        bwd_bf16<DenseQueries, true>(a, {}, static_cast<const bf16*>(out), so, lp, wp,
                                     static_cast<bf16*>(dq), B, key_tile, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (dtype == DT_F32) {
    const auto* qp = static_cast<const float*>(q);
    const auto* kp = static_cast<const float*>(k);
    const auto* vp = static_cast<const float*>(v);
    const auto* dp = static_cast<const float*>(dout);
    const cudaError_t err = launch_delta(out, dp, wp, B, H, S, so, sd, st);
    if (err != cudaSuccess) return static_cast<int>(err);
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
