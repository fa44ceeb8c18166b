// K3: FlashAttention forward: online softmax over key tiles, with
// attention dropout.
//
// Replaces the TPU kernel backpacks_flash_attn_tpu/ops/flash_attention.py
// _flash_fwd (:298, Pallas body _flash_fwd_kernel :158) for causal masking,
// per-sequence seq_lengths and q_offsets. q is (B, sq, H, 64), k and v are
// (B, sk, H, 64), each with any (batch, row, head) strides. Key u of
// sequence b is valid for query row i when u < min(seq_len[b], sk) and, if
// causal, u <= q_off[b] + i. Fully masked rows give 0 (l = 0 is treated as
// 1) and an LSE of FLASH_NEG_INF, as on the TPU. out is (B, sq, H, 64),
// contiguous, in the input's dtype; lse is (B, H, sq) f32. Dropout
// (common.cuh dropout_keep, positions q_off[b] + i and u, stream b * H + h)
// scales the kept un-normalised probabilities by 1 / (1 - p) after the
// running max and sum are taken, so the LSE stays the pre-dropout one the
// backward (K5) recomputes from.
//
// Bound on the H100: at the training shape (32 x 12 x 512, causal) the
// bytes of q, k, v and out (0.03 ms) against 6.4 GFLOP (0.007 ms); at long
// sequences the flops of the two products over the causal half (s 8192:
// 2.1e11, 0.21 ms at 989 TFLOP/s); at the serve prefill (sq = 32 over the
// first 32 columns of a cache) the bytes.
//
// bf16 with 16-byte aligned rows and scale > 0 (the tensor-core route):
// one block of WARPS warps per (query tile, head, batch row); a warp owns
// MT groups of 16 query rows. The launcher takes 64-row tiles (4 warps of
// 16 rows) up to sq 1024: at the training and forward shapes more, shorter
// blocks beat longer ones. Past that (bound by the products) 128-row
// tiles of 4 warps of 32 rows, so every K and V fragment a warp reads from
// shared memory feeds two products. The serve prefill's sq = 32 takes 2
// warps, so no warp of it idles. The loop is K9's forward
// (blocksparse_attention.cu): S = Q K^T and O += P V on mma.sync m16n8k16
// (bf16 in, f32 accumulators; K's B fragments by ldmatrix, V's by
// ldmatrix.trans; Q's A fragments by ldmatrix from shared memory each tile
// at MT = 1, held in registers at MT = 2), the online softmax per
// accumulator half in registers (max of the raw scores as a tree, 2^x of
// one fma in one MUFU instruction, scale * log2 e), P made in 16-key
// chunks, each turned into an A fragment and multiplied into O without
// touching shared memory. Dropout is a template argument, so neither form
// branches inside a tile; it is decided per fragment element at its (row,
// key) = (q0 + 16 * MT * warp + 16 * mt + g + 8 * half, j0 + 8 * nf + 2 *
// tq + e): a dropped probability is zeroed after the sum, and the
// 1 / (1 - p) of the kept ones scales O once at the end. 64-key K/V tiles
// stream through a kStages-deep cp.async ring (tile t + 1 loads while
// tile t multiplies), one barrier a tile; rows at or past the sequence's
// valid length are zero-filled without a read. A block walks key tiles
// only up to the last key any of its rows may see (causal and length
// limits); a warp skips the products of tiles past its own rows' limit,
// applies the mask (-inf) only on tiles that straddle the diagonal or the
// length, and a warp whose rows all lie past sq does no products. Query
// tiles with the most keys launch first (reverse blockIdx.y), so the
// causal tail does not leave SMs idle. Head dim 64 is a compile-time
// constant (a template argument once other head dims come). Out of scope
// in this version: wgmma, TMA and warp specialisation.
//
// f32 operands (no bf16 tensor-core form), bf16 operands whose rows or
// head offsets are not 16-byte aligned (cp.async needs 16 bytes) and a
// scale <= 0 take the SIMT loop: one 256-thread block per 64-row query
// tile, Q staged once in shared memory as f32, 32-key K/V tiles staged as
// f32, four threads a query row (8 scores each, reduced across the four
// lanes with shuffles; 16 of the 64 output columns as f32 accumulators in
// registers). The launcher decides the route once per call.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int D = 64;

// ------------------------------------------------------------ tensor cores

constexpr int BK = 64;       // keys a K/V tile
constexpr int LD = D + 8;    // 144-byte smem rows: 16-byte aligned, ldmatrix conflict-free
constexpr int kStages = 2;   // K/V tiles in the cp.async ring
constexpr float kLn2 = 0.6931471805599453f;

struct MmaArgs {
  const bf16 *q, *k, *v;
  bf16* out;
  float* lse;
  const int *seq_lengths, *q_offsets;  // NULL: sk and 0 for every sequence
  int H, sq, sk, causal;
  Strides sq_, sk_, sv_;
  float scale_log2;  // softmax scale * log2(e), > 0
  DropoutParams drop;
};

// max of the NF pairs (nf, e) a lane holds for one row (accumulator half
// `half`), as a tree
template <int NF>
__device__ __forceinline__ float row_max(const float (&s)[NF][4], int half) {
  float m[NF];
#pragma unroll
  for (int nf = 0; nf < NF; ++nf) m[nf] = fmaxf(s[nf][2 * half], s[nf][2 * half + 1]);
#pragma unroll
  for (int w = NF / 2; w > 0; w >>= 1)
#pragma unroll
    for (int i = 0; i < w; ++i) m[i] = fmaxf(m[i], m[i + w]);
  return m[0];
}

// The per-warp state of the online softmax: Q's A fragments, and per row
// group and accumulator half (rows g, g + 8) the running max in log2 units
// (-inf: no valid key yet), the pre-dropout sum and the output rows.
template <int MT>
struct WarpRows {
  uint32_t qa[MT][D / 16][4];
  float m[MT][2], l[MT][2];
  float o[MT][D / 8][4];
};

// Q's A fragments: at MT = 1 (128 registers a thread) read from shared
// memory for every tile (ldmatrix), at MT = 2 held in registers
template <int MT>
constexpr bool kQInSmem = MT == 1;

// One BK-key tile (K and V in shared memory, [key][d]) into the warp's
// rows qw, ..., qw + 16 * MT - 1 (rows qs, ... of the Q tile in shared
// memory)
template <int MT, bool DROP>
__device__ __forceinline__ void attend_tile(WarpRows<MT>& w, const bf16* Qs, int qs,
                                            const bf16* Ks, const bf16* Vs, const MmaArgs& a,
                                            int j0, int qw, int q_off, int kv_len, bool edge,
                                            uint32_t bh) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  // S = Q K^T: one ldmatrix.x4 gives the B fragments of two 8-key blocks
  float s[MT][BK / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) zero(s[mt]);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t qf[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (kQInSmem<MT>)
        ldmatrix_x4(qf[mt], Qs + (qs + 16 * mt + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
      else
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[mt][e] = w.qa[mt][ks][e];
    }
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t bk[4];
      ldmatrix_x4(bk, Ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + ks * 16 +
                          ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_16816(s[mt][2 * np], qf[mt], bk);
        mma_16816(s[mt][2 * np + 1], qf[mt], bk + 2);
      }
    }
  }
  // the mask (-inf) only on tiles that straddle the length or the
  // diagonal (a warp-uniform branch); the running max of the raw scores
  // (scale > 0); o and l rescaled once
  if (edge) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = qw + 16 * mt + g + 8 * half;
        const int lim = a.causal ? min(kv_len, q_off + row + 1) : kv_len;  // keys below are valid
#pragma unroll
        for (int nf = 0; nf < BK / 8; ++nf)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (j0 + nf * 8 + 2 * tq + e >= lim) s[mt][nf][2 * half + e] = -INFINITY;
      }
  }
  float mu[MT][2];  // the max the exponents subtract (0 while no key is valid)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float m_new =
          fmaxf(w.m[mt][half], group_max(row_max(s[mt], half), 4) * a.scale_log2);
      mu[mt][half] = m_new == -INFINITY ? 0.f : m_new;
      const float corr = ex2(w.m[mt][half] - mu[mt][half]);
      w.m[mt][half] = m_new;
      w.l[mt][half] *= corr;
#pragma unroll
      for (int nf = 0; nf < D / 8; ++nf) {
        w.o[mt][nf][2 * half] *= corr;
        w.o[mt][nf][2 * half + 1] *= corr;
      }
    }
  // P in 16-key chunks, each turned into one A fragment and multiplied
  // into O as it is made. Dropout zeroes the dropped probabilities after
  // the sum; the 1 / (1 - p) of the kept ones is applied to O at the end.
  float rs[MT][2][2] = {};  // two partial sums a row
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int nf = 2 * kk + n2;
          float p[2], kept[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            p[e] = ex2(fmaf(s[mt][nf][2 * half + e], a.scale_log2, -mu[mt][half]));
            kept[e] = !DROP || dropout_keep(
                                   a.drop, bh,
                                   static_cast<uint32_t>(q_off + qw + 16 * mt + g + 8 * half),
                                   static_cast<uint32_t>(j0 + nf * 8 + 2 * tq + e))
                          ? p[e]
                          : 0.f;
          }
          rs[mt][half][n2] += p[0] + p[1];
          pa[mt][n2 * 2 + half] = pack_bf16x2(kept[0], kept[1]);  // to_a's slot for (nf, half)
        }
#pragma unroll
    for (int nj = 0; nj < D / 16; ++nj) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, Vs + (kk * 16 + (lane & 15)) * LD + nj * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_16816(w.o[mt][2 * nj], pa[mt], bv);
        mma_16816(w.o[mt][2 * nj + 1], pa[mt], bv + 2);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    w.l[mt][0] += group_sum(rs[mt][0][0] + rs[mt][0][1], 4);
    w.l[mt][1] += group_sum(rs[mt][1][0] + rs[mt][1][1], 4);
  }
}

// One block per (query tile of 16 * MT * WARPS rows, head, batch row).
// A warp owns MT groups of 16 query rows, so every K and V fragment it
// reads from shared memory feeds MT products; 16 warps an SM at MT = 1
// (at most 128 registers a thread), 8 at MT = 2 (at most 255). DROP is
// whether dropout is on, so neither form branches inside the tile.
template <int WARPS, int MT, bool DROP>
__global__ void __launch_bounds__(32 * WARPS, 16 / (WARPS * MT))
    flash_fwd_mma_kernel(const MmaArgs a) {
  constexpr int RW = 16 * MT, BQ = RW * WARPS, kThreads = 32 * WARPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* ring = Qs + BQ * LD;                     // kStages x (K, V), BK x LD each

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the tiles with the most keys first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
  const int qw = q0 + RW * warp;  // the warp's first query row
  const int kv_len = a.seq_lengths ? min(a.seq_lengths[b], a.sk) : a.sk;
  const int q_off = a.q_offsets ? a.q_offsets[b] : 0;
  // keys at or past these bounds are masked for every row of the block,
  // and of the warp (0: the warp's rows all lie past sq)
  const int kv_end = a.causal ? min(kv_len, q_off + min(q0 + BQ, a.sq)) : kv_len;
  const int warp_end =
      qw >= a.sq ? 0 : a.causal ? min(kv_len, q_off + min(qw + RW, a.sq)) : kv_len;
  const int n_tiles = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  const bf16* kb = a.k + b * a.sk_.sb + h * a.sk_.sh;
  const bf16* vb = a.v + b * a.sv_.sb + h * a.sv_.sh;
  auto load_kv = [&](int t) {
    bf16* Ks = ring + (t % kStages) * 2 * BK * LD;
    load_rows_async<BK, kThreads>(Ks, kb, a.sk_.st, t * BK, kv_len);
    load_rows_async<BK, kThreads>(Ks + BK * LD, vb, a.sv_.st, t * BK, kv_len);
  };
  // Q goes with the first K/V tile's commit group
  if (n_tiles > 0)
    load_rows_async<BQ, kThreads>(Qs, a.q + b * a.sq_.sb + h * a.sq_.sh, a.sq_.st, q0, a.sq);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }

  WarpRows<MT> w;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    w.m[mt][0] = w.m[mt][1] = -INFINITY;
    w.l[mt][0] = w.l[mt][1] = 0.f;
    zero(w.o[mt]);
  }
  const uint32_t bh = static_cast<uint32_t>(b * a.H + h);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t (and Q) have landed
    __syncthreads();               // ... for every thread; tile t - 1 is consumed
    if (t + kStages - 1 < n_tiles) load_kv(t + kStages - 1);
    cp_async_commit();
    const int j0 = t * BK;
    if (!kQInSmem<MT> && t == 0 && warp_end > 0)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) a_frags(w.qa[mt], Qs, LD, RW * warp + 16 * mt, g, tq);
    if (j0 >= warp_end) continue;  // warp-uniform: no key of the tile for these rows
    const bf16* Ks = ring + (t % kStages) * 2 * BK * LD;
    const bool edge = j0 + BK > kv_len || (a.causal && j0 + BK - 1 > q_off + qw);
    attend_tile<MT, DROP>(w, Qs, RW * warp, Ks, Ks + BK * LD, a, j0, qw, q_off, kv_len, edge,
                          bh);
  }
  cp_async_wait<0>();

  const float keep_scale = DROP ? a.drop.inv_keep : 1.f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = qw + 16 * mt + g + 8 * half;
      if (row >= a.sq) continue;
      const float lv = w.l[mt][half];
      const float inv = lv == 0.f ? 1.f : keep_scale / lv;
      bf16* orow = a.out + ((static_cast<long long>(b) * a.sq + row) * a.H + h) * D;
#pragma unroll
      for (int nf = 0; nf < D / 8; ++nf)
        *reinterpret_cast<__nv_bfloat162*>(orow + nf * 8 + 2 * tq) =
            __floats2bfloat162_rn(w.o[mt][nf][2 * half] * inv, w.o[mt][nf][2 * half + 1] * inv);
      if (tq == 0)
        a.lse[(static_cast<long long>(b) * a.H + h) * a.sq + row] =
            lv == 0.f ? FLASH_NEG_INF : (w.m[mt][half] + log2f(lv)) * kLn2;
    }
}

template <int WARPS, int MT, bool DROP>
int launch_form(const MmaArgs& a, long long B, cudaStream_t stream) {
  constexpr int BQ = 16 * MT * WARPS;
  const size_t smem = sizeof(bf16) * (BQ + 2 * kStages * BK) * LD;
  const cudaError_t err = allow_smem<flash_fwd_mma_kernel<WARPS, MT, DROP>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * a.H), static_cast<unsigned>((a.sq + BQ - 1) / BQ));
  flash_fwd_mma_kernel<WARPS, MT, DROP><<<grid, 32 * WARPS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int WARPS, int MT>
int launch_mma(const MmaArgs& a, long long B, cudaStream_t stream) {
  return a.drop.on ? launch_form<WARPS, MT, true>(a, B, stream)
                   : launch_form<WARPS, MT, false>(a, B, stream);
}

bool aligned16(const void* p, long long sb, long long st, long long sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 && st % 8 == 0 && sh % 8 == 0;
}

// ------------------------------------------------------------ SIMT (f32, unaligned bf16)

constexpr int BQ_SIMT = 64, BKV_SIMT = 32, kSimtThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kSimtThreads)
flash_fwd_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                      const int* __restrict__ seq_lengths, const int* __restrict__ q_offsets,
                      int H, int sq, int sk, long long q_sb, long long q_st, long long q_sh,
                      long long k_sb, long long k_st, long long k_sh, long long v_sb,
                      long long v_st, long long v_sh, float scale, int causal,
                      DropoutParams drop) {
  __shared__ float Qs[BQ_SIMT][D + 1];
  __shared__ float Ks[BKV_SIMT][D + 1];
  __shared__ float Vs[BKV_SIMT][D];
  __shared__ float Ps[BQ_SIMT][BKV_SIMT + 1];

  const int q0 = blockIdx.x * BQ_SIMT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid >> 2, c = tid & 3;  // query row in the tile, lane in its group of 4
  const int kv_len = seq_lengths ? min(seq_lengths[b], sk) : sk;  // NULL: sk and 0
  const int q_off = q_offsets ? q_offsets[b] : 0;
  const int qi = q0 + r;                // query row index
  const int q_pos = q_off + qi;         // its absolute position

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  for (int idx = tid; idx < BQ_SIMT * D; idx += kSimtThreads) {
    const int rr = idx / D, dd = idx % D;
    Qs[rr][dd] = q0 + rr < sq ? to_f32(qb[(q0 + rr) * q_st + dd]) : 0.f;
  }

  // keys past this bound are masked for every row of the tile
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, q_off + q0 + BQ_SIMT);

  float m = FLASH_NEG_INF, l = 0.f;
  float o[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) o[j] = 0.f;

  for (int j0 = 0; j0 < kv_end; j0 += BKV_SIMT) {
    __syncthreads();  // previous tile fully consumed (and Q staged)
    for (int idx = tid; idx < BKV_SIMT * D; idx += kSimtThreads) {
      const int rr = idx / D, dd = idx % D;
      const bool in = j0 + rr < sk;
      Ks[rr][dd] = in ? to_f32(kb[(j0 + rr) * k_st + dd]) : 0.f;
      Vs[rr][dd] = in ? to_f32(vb[(j0 + rr) * v_st + dd]) : 0.f;
    }
    __syncthreads();

    float s[BKV_SIMT / 4];
    float tile_max = FLASH_NEG_INF;
#pragma unroll
    for (int i = 0; i < BKV_SIMT / 4; ++i) {
      const int kk = c + 4 * i;
      float acc = 0.f;
#pragma unroll 16
      for (int dd = 0; dd < D; ++dd) acc += Qs[r][dd] * Ks[kk][dd];
      const int kpos = j0 + kk;
      const bool valid = kpos < kv_len && (!causal || kpos <= q_pos);
      s[i] = valid ? acc * scale : FLASH_NEG_INF;
      tile_max = fmaxf(tile_max, s[i]);
    }
    const float m_new = fmaxf(m, group_max(tile_max, 4));
    const float corr = expf(m - m_new);
    float tile_sum = 0.f;
#pragma unroll
    for (int i = 0; i < BKV_SIMT / 4; ++i) {
      float p = s[i] == FLASH_NEG_INF ? 0.f : expf(s[i] - m_new);
      tile_sum += p;
      if (drop.on)
        p = dropout_keep(drop, static_cast<uint32_t>(b * H + h), static_cast<uint32_t>(q_pos),
                         static_cast<uint32_t>(j0 + c + 4 * i))
                ? p * drop.inv_keep
                : 0.f;
      Ps[r][c + 4 * i] = p;
    }
    l = l * corr + group_sum(tile_sum, 4);
    m = m_new;
#pragma unroll
    for (int j = 0; j < D / 4; ++j) o[j] *= corr;
    __syncwarp();  // the row's four lanes share one warp
#pragma unroll 8
    for (int kk = 0; kk < BKV_SIMT; ++kk) {
      const float p = Ps[r][kk];
#pragma unroll
      for (int j = 0; j < D / 4; ++j) o[j] += p * Vs[kk][c + 4 * j];
    }
  }

  if (qi >= sq) return;
  const float l_safe = l == 0.f ? 1.f : l;
  const float inv = 1.f / l_safe;
  T* orow = out + ((static_cast<long long>(b) * sq + qi) * H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 4; ++j) orow[c + 4 * j] = from_f32<T>(o[j] * inv);
  if (c == 0) lse[(static_cast<long long>(b) * H + h) * sq + qi] = m + logf(l_safe);
}

template <typename T>
int launch_simt(const void* q, const void* k, const void* v, void* out, void* lse,
                const void* seq_lengths, const void* q_offsets, long long B, long long H,
                long long sq, long long sk, long long q_sb, long long q_st, long long q_sh,
                long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
                long long v_sh, float scale, long long causal, DropoutParams drop,
                cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((sq + BQ_SIMT - 1) / BQ_SIMT), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  flash_fwd_simt_kernel<T><<<grid, kSimtThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), static_cast<const int*>(seq_lengths),
      static_cast<const int*>(q_offsets), static_cast<int>(H), static_cast<int>(sq),
      static_cast<int>(sk), q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale,
      static_cast<int>(causal), drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      void* lse, const void* seq_lengths,
                                      const void* q_offsets, long long B, long long H,
                                      long long sq, long long sk, long long q_sb,
                                      long long q_st, long long q_sh, long long k_sb,
                                      long long k_st, long long k_sh, long long v_sb,
                                      long long v_st, long long v_sh, float scale,
                                      long long causal, long long seed0, long long seed1,
                                      long long thr, float inv_keep, long long dropout,
                                      long long dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * H * sq == 0) return 0;
  const DropoutParams drop = make_dropout(seed0, seed1, thr, inv_keep, dropout);
  if (dtype == DT_BF16 && scale > 0.f && aligned16(q, q_sb, q_st, q_sh) &&
      aligned16(k, k_sb, k_st, k_sh) && aligned16(v, v_sb, v_st, v_sh)) {
    const MmaArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(out),
                    static_cast<float*>(lse), static_cast<const int*>(seq_lengths),
                    static_cast<const int*>(q_offsets), static_cast<int>(H),
                    static_cast<int>(sq), static_cast<int>(sk), static_cast<int>(causal),
                    Strides{q_sb, q_st, q_sh}, Strides{k_sb, k_st, k_sh},
                    Strides{v_sb, v_st, v_sh}, scale * kLog2e, drop};
    // the serve prefill's 32 queries take a 32-row tile, so no warp idles;
    // 64-row tiles of 4 warps up to sq 1024; longer sequences (bound by
    // the products) 128-row tiles of 4 warps of 32 rows, which halve the
    // shared-memory reads per product
    if (sq <= 32) return launch_mma<2, 1>(a, B, st);
    if (sq <= 1024) return launch_mma<4, 1>(a, B, st);
    return launch_mma<4, 2>(a, B, st);
  }
#define K3_ARGS q, k, v, out, lse, seq_lengths, q_offsets, B, H, sq, sk, q_sb, q_st, q_sh, \
                k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, causal, drop, st
  if (dtype == DT_BF16) return launch_simt<__nv_bfloat16>(K3_ARGS);
  if (dtype == DT_F32) return launch_simt<float>(K3_ARGS);
#undef K3_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
