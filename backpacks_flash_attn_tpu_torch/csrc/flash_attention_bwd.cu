// K5: FlashAttention backward (dq, dk, dv), with the dropout mask
// regenerated from its seed.
//
// Replaces the TPU kernel backpacks_flash_attn_tpu/ops/flash_attention.py
// _flash_bwd (:794) in its default form, the single-pass Pallas body
// _flash_bwd_scratch_kernel (:681): each (query tile, key tile) pair is
// recomputed once and feeds all three gradients (5 products), dq summed in
// f32 across the key tiles. (The no-bias contract of _flash_bwd_fused_kernel
// :590 and of the split _flash_bwd_dq_kernel :460 + _flash_bwd_dkv_kernel
// :523 is the same function.) Head dims 64, 80, 96 and 128, an instance
// each (the wrapper pads any other d <= 128 with zero columns to the next,
// as JAX's _head_pad :78 pads to 128), any sq and sk, causal or not, bf16
// or f32 in and out, f32 accumulators. The ring forms (JAX's q_offsets,
// k_offsets, bh_offset, :794-806): causality sees q_off[b] - k_off[b],
// which may be negative (a pair whose keys all follow its queries gives
// exact zeros: no query tile is visited), the dropout hash the absolute
// positions and the stream (bh_offset + b) * hash_heads + head_offset + h
// (a tensor-parallel head shard, heads [head_offset, head_offset + H) of
// hash_heads, draws the unsharded call's mask).
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
// row's 32 scores per tile and holding D / 8 of its D gradient columns;
// every product in f32, scores recomputed in both kernels, no atomics.
// Their tiles sit in static shared memory where they all fit its 48 KB
// (D 64; dq's at D 80 too); past it (the dK/dV kernel's 50.2 KB at D 80)
// the D-wide ones (Q, dO, K, V) move to dynamic shared memory. The helpers
// and sizes they share with K9's SIMT kernels are in the header.
//
// An additive f32 score bias (JAX _flash_bwd's bias with its dbias output,
// :460-558 and :1009-1036) is a template flag of both routes, so the
// instances without one are the code they were. p is recomputed with the
// bias (read at its broadcast strides, queries clamped below Sq and keys
// below Sk), and each pair's f32 dS = p * (dp_kept - delta) is stored once
// into a (B, H, Sq, Sk) dbias the wrapper zeroes (the pairs the masks or
// the causal walk leave out stay 0; the wrapper sums the broadcast dims):
// on the tensor-core route by the warp that owns the pair's key, on the
// SIMT route by the dQ kernel, so no atomics. The tensor-core bias
// instances are built at 128-key tiles only (the wrapper asks for them),
// in the dropout form with a branch on whether dropout is on; they turn
// S^T into log2 units with the bias in it before the elementwise pass
// (add_bias), so that pass holds no bias addresses.
#include "flash_attention_bwd.cuh"

namespace {

// the ring forms' offsets, as BwdArgs carries them to the bf16 body
struct Offsets {
  const int *q, *k;  // (B,) absolute positions of query row 0 and key column 0, or NULL
  int bh;            // the global index of batch row 0
  int hash_heads;    // the unsharded call's heads (H without a head shard)
  int head_offset;   // the global index of head 0 (0 without a head shard)
};

// sequence b's relative offset rel = q_off - k_off (key u is visible to
// query i at u <= i + rel, causal), the absolute positions of its row 0
// and column 0 for the dropout hash, and head h's dropout stream
struct Pos {
  int rel, q_abs, k_abs;
  uint32_t bh;
  __device__ __forceinline__ Pos(const Offsets& o, int b, int h)
      : rel(0), q_abs(o.q ? o.q[b] : 0), k_abs(o.k ? o.k[b] : 0),
        bh(static_cast<uint32_t>((o.bh + b) * o.hash_heads + o.head_offset + h)) {
    rel = q_abs - k_abs;
  }
};

// ------------------------------------------------------------- f32 (SIMT)

// one block per (32-key tile, head, batch row); thread (r, c) = key k0 + r,
// queries c + 8 i of each tile, gradient columns c + 8 j
template <int D, bool BIAS>
__global__ void __launch_bounds__(kSimtThreads)
dkdv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int H, int Sq, int Sk,
                 Strides sq, Strides sk, Strides sv, Strides sd, float scale, int causal,
                 DropoutParams drop, Offsets off, ScoreBias bias) {
  constexpr int R = kDkdvStatic<D> ? ST : 1;
  __shared__ float Ks_s[R][D + 1], Vs_s[R][D + 1], Qs_s[R][D + 1], Ds_s[R][D + 1];
  __shared__ float Ps[ST][ST + 1], DSs[ST][ST + 1];
  __shared__ float Ls[ST], Dl[ST];
  float(*Ks)[D + 1] = Ks_s, (*Vs)[D + 1] = Vs_s, (*Qs)[D + 1] = Qs_s, (*Ds)[D + 1] = Ds_s;
  if constexpr (R == 1) {
    DynRows dyn;
    Ks = dyn.take<D + 1>(ST);
    Vs = dyn.take<D + 1>(ST);
    Qs = dyn.take<D + 1>(ST);
    Ds = dyn.take<D + 1>(ST);
  }
  const int k0 = blockIdx.x * ST, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7, key = k0 + r;
  const long long bh = static_cast<long long>(b) * H + h;
  const Pos pos(off, b, h);
  // the bias column of key `key` (clamped below Sk: keys past it are masked)
  const float* bcol = BIAS ? bias.p + b * bias.sb + h * bias.sh + min(key, Sk - 1) : nullptr;
  load_rows<D>(Ks, k + b * sk.sb + h * sk.sh, sk.st, k0, Sk);
  load_rows<D>(Vs, v + b * sv.sb + h * sv.sh, sv.st, k0, Sk);
  float dk_acc[D / 8], dv_acc[D / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  const float* qb = q + b * sq.sb + h * sq.sh;
  const float* db = dout + b * sd.sb + h * sd.sh;
  // the first query tile any key of the block sees (causal: query k0 - rel)
  const int first = causal ? max((k0 - pos.rel >= 0 ? (k0 - pos.rel) / ST
                                                    : -((pos.rel - k0 + ST - 1) / ST)) * ST, 0)
                           : 0;
  for (int q0 = first; q0 < Sq; q0 += ST) {
    __syncthreads();  // the previous tiles are consumed (and K, V staged)
    load_rows<D>(Qs, qb, sq.st, q0, Sq);
    load_rows<D>(Ds, db, sd.st, q0, Sq);
    for (int i = threadIdx.x; i < ST; i += kSimtThreads) {
      const bool in = q0 + i < Sq;
      Ls[i] = in ? lse[bh * Sq + q0 + i] : 0.f;
      Dl[i] = in ? delta[bh * Sq + q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ST / 8; ++i) {
      const int ql = c + 8 * i, qry = q0 + ql;
      const bool valid = key < Sk && qry < Sq && (!causal || key <= qry + pos.rel);
      float p;
      if constexpr (BIAS)
        p = valid ? expf(dot<D>(Ks[r], Qs[ql]) * scale +
                         __ldg(bcol + min(qry, Sq - 1) * bias.sq) - Ls[ql])
                  : 0.f;
      else
        p = valid ? expf(dot<D>(Ks[r], Qs[ql]) * scale - Ls[ql]) : 0.f;
      float dp = dot<D>(Vs[r], Ds[ql]), pk = p;
      if (drop.on) {
        const bool keep = dropout_keep(drop, pos.bh, static_cast<uint32_t>(pos.q_abs + qry),
                                       static_cast<uint32_t>(pos.k_abs + key));
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
  if (key >= Sk) return;
  const long long o = ((static_cast<long long>(b) * Sk + key) * H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk[o + c + 8 * j] = dk_acc[j] * scale;
    dv[o + c + 8 * j] = dv_acc[j];
  }
}

// one block per (32-query tile, head, batch row); thread (r, c) = query
// q0 + r, keys c + 8 i of each tile, gradient columns c + 8 j
template <int D, bool BIAS>
__global__ void __launch_bounds__(kSimtThreads)
dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, int H, int Sq, int Sk, Strides sq, Strides sk,
               Strides sv, Strides sd, float scale, int causal, DropoutParams drop, Offsets off,
               ScoreBias bias) {
  constexpr int R = kDqStatic<D> ? ST : 1;
  __shared__ float Qs_s[R][D + 1], Ds_s[R][D + 1], Ks_s[R][D + 1], Vs_s[R][D + 1];
  __shared__ float DSs[ST][ST + 1];
  float(*Qs)[D + 1] = Qs_s, (*Ds)[D + 1] = Ds_s, (*Ks)[D + 1] = Ks_s, (*Vs)[D + 1] = Vs_s;
  if constexpr (R == 1) {
    DynRows dyn;
    Qs = dyn.take<D + 1>(ST);
    Ds = dyn.take<D + 1>(ST);
    Ks = dyn.take<D + 1>(ST);
    Vs = dyn.take<D + 1>(ST);
  }
  const int q0 = blockIdx.x * ST, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7, qry = q0 + r;
  const long long bh = static_cast<long long>(b) * H + h;
  const Pos pos(off, b, h);
  // the bias row of query qry (clamped below Sq: rows past it are not
  // stored) and its dbias row
  const float* brow =
      BIAS ? bias.p + b * bias.sb + h * bias.sh + min(qry, Sq - 1) * bias.sq : nullptr;
  float* gbrow = BIAS && bias.grad ? bias.grad + (bh * Sq + qry) * Sk : nullptr;
  load_rows<D>(Qs, q + b * sq.sb + h * sq.sh, sq.st, q0, Sq);
  load_rows<D>(Ds, dout + b * sd.sb + h * sd.sh, sd.st, q0, Sq);
  const float row_lse = qry < Sq ? lse[bh * Sq + qry] : 0.f;
  const float row_delta = qry < Sq ? delta[bh * Sq + qry] : 0.f;
  float dq_acc[D / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq_acc[j] = 0.f;

  const float* kb = k + b * sk.sb + h * sk.sh;
  const float* vb = v + b * sv.sb + h * sv.sh;
  const int kv_end = causal ? min(Sk, q0 + pos.rel + ST) : Sk;
  for (int j0 = 0; j0 < kv_end; j0 += ST) {
    __syncthreads();
    load_rows<D>(Ks, kb, sk.st, j0, Sk);
    load_rows<D>(Vs, vb, sv.st, j0, Sk);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ST / 8; ++i) {
      const int kl = c + 8 * i, key = j0 + kl;
      const bool valid = key < Sk && qry < Sq && (!causal || key <= qry + pos.rel);
      float p;
      if constexpr (BIAS)
        p = valid ? expf(dot<D>(Qs[r], Ks[kl]) * scale + __ldg(brow + min(key, Sk - 1)) - row_lse)
                  : 0.f;
      else
        p = valid ? expf(dot<D>(Qs[r], Ks[kl]) * scale - row_lse) : 0.f;
      float dp = dot<D>(Ds[r], Vs[kl]);
      if (drop.on)
        dp = dropout_keep(drop, pos.bh, static_cast<uint32_t>(pos.q_abs + qry),
                          static_cast<uint32_t>(pos.k_abs + key))
                 ? dp * drop.inv_keep
                 : 0.f;
      DSs[r][kl] = p * (dp - row_delta);
      if constexpr (BIAS)
        if (gbrow && valid) gbrow[key] = DSs[r][kl];
    }
    __syncwarp();
    for (int kl = 0; kl < ST; ++kl) {
      const float ds = DSs[r][kl];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) dq_acc[j] += ds * Ks[kl][c + 8 * j];
    }
  }
  if (qry >= Sq) return;
  float* drow = dq + ((static_cast<long long>(b) * Sq + qry) * H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) drow[c + 8 * j] = dq_acc[j] * scale;
}

// the f32 route at head dim D: delta, then the dK/dV and dQ kernels
template <int D, bool BIAS>
cudaError_t simt_form(const float* q, const float* k, const float* v, const void* out,
                      const float* dout, const float* lse, float* ws, float* dq, float* dk,
                      float* dv, long long B, long long H, long long Sq, long long Sk, Strides sq,
                      Strides sk, Strides sv, Strides so, Strides sd, float scale, int causal,
                      DropoutParams drop, Offsets off, cudaStream_t st, ScoreBias bias) {
  cudaError_t err = launch_delta(out, dout, ws, B, H, Sq, D, so, sd, st);
  if (err != cudaSuccess) return err;
  const size_t kv_smem = kDkdvStatic<D> ? 0 : 4 * kSimtDynFloats<D>;
  const size_t q_smem = kDqStatic<D> ? 0 : 4 * kSimtDynFloats<D>;
  if (kv_smem > 0 && (err = allow_smem<dkdv_simt_kernel<D, BIAS>>(kv_smem)) != cudaSuccess)
    return err;
  if (q_smem > 0 && (err = allow_smem<dq_simt_kernel<D, BIAS>>(q_smem)) != cudaSuccess) return err;
  const int h = static_cast<int>(H), sq_n = static_cast<int>(Sq), sk_n = static_cast<int>(Sk);
  const dim3 kv_grid(static_cast<unsigned>((Sk + ST - 1) / ST), static_cast<unsigned>(H),
                     static_cast<unsigned>(B));
  const dim3 q_grid(static_cast<unsigned>((Sq + ST - 1) / ST), static_cast<unsigned>(H),
                    static_cast<unsigned>(B));
  dkdv_simt_kernel<D, BIAS><<<kv_grid, kSimtThreads, kv_smem, st>>>(
      q, k, v, dout, lse, ws, dk, dv, h, sq_n, sk_n, sq, sk, sv, sd, scale, causal, drop, off,
      bias);
  dq_simt_kernel<D, BIAS><<<q_grid, kSimtThreads, q_smem, st>>>(
      q, k, v, dout, lse, ws, dq, h, sq_n, sk_n, sq, sk, sv, sd, scale, causal, drop, off, bias);
  return cudaGetLastError();
}

template <int D, class... Args>
cudaError_t simt_bwd(const ScoreBias& bias, Args... args) {
  return bias.p ? simt_form<D, true>(args..., bias) : simt_form<D, false>(args..., bias);
}

}  // namespace

// q, out, dout: (B, Sq, H, d), k, v: (B, Sk, H, d), bf16 or f32 (dtype)
// with the given (batch, row, head) strides, bf16 rows 16-byte aligned, d
// 64, 80, 96 or 128; lse (B, H, Sq) f32; ws: f32 workspace, bf16: the dq
// accumulator (B * Sq * H * d) then the LSE and delta tables (B * H * Sq_pad
// each, Sq_pad = Sq rounded up to 64); f32: delta (B * H * Sq). dq (B, Sq,
// H, d), dk, dv (B, Sk, H, d): contiguous outputs of the operands' dtype.
// q_offsets, k_offsets: (B,) int32 absolute positions of query row 0 and
// key column 0 of each sequence, or NULL (0); bh_offset: the global index
// of batch row 0 (the ring forms: out and lse are then the rows' GLOBAL
// ones, so each call gives one chunk pair's exact share of the gradients);
// head_offset, hash_heads: the call's heads are heads [head_offset,
// head_offset + H) of hash_heads (a tensor-parallel head shard; 0 and H
// without one), which key the dropout stream.
// key_tile (bf16): 64 or 128 keys a CTA (128 with a bias). bias: NULL, or a
// host array {address, batch, head and row strides, dbias address} of the
// f32 score bias (common.cuh ScoreBias; dbias (B, H, Sq, Sk) f32 zeroed,
// or 0 for none).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, void* ws, void* dq, void* dk, void* dv, const void* q_offsets,
    const void* k_offsets, const long long* bias, long long bh_offset, long long head_offset,
    long long hash_heads, long long B, long long H, long long Sq,
    long long Sk, long long q_sb, long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh, long long o_sb,
    long long o_st, long long o_sh, long long d_sb, long long d_st, long long d_sh, float scale,
    long long causal, long long seed0, long long seed1, long long thr, float inv_keep,
    long long dropout, long long key_tile, long long d, long long dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutParams drop = make_dropout(seed0, seed1, thr, inv_keep, dropout);
  const Strides sq{q_sb, q_st, q_sh}, sk{k_sb, k_st, k_sh}, sv{v_sb, v_st, v_sh},
      so{o_sb, o_st, o_sh}, sd{d_sb, d_st, d_sh};
  const int h = static_cast<int>(H);
  const int c = static_cast<int>(causal);
  const Offsets off{static_cast<const int*>(q_offsets), static_cast<const int*>(k_offsets),
                    static_cast<int>(bh_offset), static_cast<int>(hash_heads),
                    static_cast<int>(head_offset)};
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
    a.Sq = static_cast<int>(Sq);
    a.Sk = static_cast<int>(Sk);
    a.q_offsets = off.q;
    a.k_offsets = off.k;
    a.bh_offset = off.bh;
    a.hash_heads = off.hash_heads;
    a.head_offset = off.head_offset;
    a.causal = c;
    a.sq = sq;
    a.sk = sk;
    a.sv = sv;
    a.sd = sd;
    a.scale = scale;
    a.drop = drop;
    a.bias = read_bias(bias);
    return static_cast<int>(with_head_dim(d, [&](auto D) {
      return bwd_bf16<D, DenseQueries, true, true>(a, {}, static_cast<const bf16*>(out), so, lp, wp,
                                             static_cast<bf16*>(dq), B, key_tile, st);
    }));
  }
  if (dtype != DT_F32) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_head_dim(d, [&](auto D) {
    return simt_bwd<D>(read_bias(bias), static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), out, static_cast<const float*>(dout), lp,
                       wp, static_cast<float*>(dq), static_cast<float*>(dk),
                       static_cast<float*>(dv), B, H, Sq, Sk, sq, sk, sv, so, sd, scale, c, drop,
                       off, st);
  }));
}
