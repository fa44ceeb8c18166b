// The single-query decode attention of K1 and K1-blockdiag
// (decode_attention.cu), K1-selector (decode_attention_selector.cu), K8
// (lowbit_decode_attention.cu) and K1-gathered (decode_attention_gathered.cu):
// one kernel body over four key/value formats. Its stream (stream_segment:
// one row group, a run of one row's group tiles) and its merge of a group's
// warps (merge_warps, the output through a sink) serve two schedules: a row
// group a row (decode_rows, split over a cluster for few rows) and
// K1-gathered's balanced split of all rows' tiles over the card.
//
//   FMT_K1     K1: kt (E, dk, S) and v (E, S, dv) of one element type (f32,
//              bf16 or int8), scales (E, S) or none.
//   FMT_VT     the selector: as FMT_K1, values (E, dv, S) (any dv >= 1).
//   FMT_INT4   K8: packed column j of kt4 (E, dk, S/2) and v4 (E, S/2, dv)
//              holds positions 2j (low nibble) and 2j + 1 (high nibble);
//              scales (E, 2, S/2), the parity on the middle axis.
//   FMT_MIXED  K8 over the mixed cache: int8 keys (E, dk, 2, S/2), a d row
//              two runs (even positions, then odd); values and scales as
//              FMT_INT4.
//
// A K8 "column" is a packed column: its keys are one byte a d row (two for
// FMT_MIXED), its values one byte a channel, its scales two floats. So the
// K8 layouts are K1's INT8 ones with two positions to a column, and one
// body serves both (the design notes in decode_attention.cu; K8's launch
// shape in lowbit_decode_attention.cu). K8 scores both positions of a
// column, masks them apart (2j < len, 2j + 1 < len), takes one max over
// both before any exp and sums l with it.
//
// Nibbles decode by word: a lane's 4-byte word holds 8 key nibbles (4
// columns x 2 positions) or 4 value channels x 2 positions. The low and
// high nibbles, each xor 8, go by __byte_perm into the mantissa of 128.0,
// which gives 128 + (n + 8) exactly with no conversion and no subtraction;
// the offset kNibOff = 136 comes off a sum once: the scores start at
// -136 x (the lane's share of sum q), the values subtract 136 x (the
// lane's sum of weights) before the merge. Products of a bf16 q with such a
// value are exact in f32.
//
// FMT_VT's value tile is channel-major: channel c's Tg positions are one
// 16-byte-chunked row of the slab (the copies run along s, as the cache
// does), rows ordered by c % 4 then c / 4 and chunks swizzled by row, so that
// the lanes of a load (one channel of each lane's quad) hit distinct banks.
// The warp's slice of a row is one or two units of U = min(16, Tw elt) bytes;
// a lane reads a unit of each of its channels as one 16- or 8-byte word and
// the unit's weights once, then does U / elt FMAs a word. The accumulators
// keep FMT_K1's layout (a lane's quads lq + LP j), so the merge is shared.
#pragma once

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxSplit = 8;
constexpr float kNeg = -1e30f;   // decode_attention.py NEG
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNibOff = 136.f;

enum { FMT_K1 = 0, FMT_INT4 = 1, FMT_MIXED = 2, FMT_VT = 3 };

// four int8 (one word) as f32: the byte, offset by 128, becomes the low
// mantissa byte of 2^23 (__byte_perm with 0x4B000000), and one subtraction
// of 2^23 + 128 restores its value exactly
__device__ __forceinline__ float4 i8x4_f32(uint32_t w) {
  constexpr float kBias = 8388736.f;
  const uint32_t x = w ^ 0x80808080u;
  return make_float4(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650)) - kBias,
                     __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7651)) - kBias,
                     __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7652)) - kBias,
                     __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7653)) - kBias);
}

// the eight int4 values of a word as f32 plus kNibOff: byte i's low nibble
// to lo[i], its high nibble to hi[i] (each nibble xor 8 into byte 2 of
// 128.0 = 0x43000000)
__device__ __forceinline__ void nib8(uint32_t w, float (&lo)[4], float (&hi)[4]) {
  const uint32_t l = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t h = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
  lo[0] = __uint_as_float(__byte_perm(l, 0x43000000u, 0x7044));
  lo[1] = __uint_as_float(__byte_perm(l, 0x43000000u, 0x7144));
  lo[2] = __uint_as_float(__byte_perm(l, 0x43000000u, 0x7244));
  lo[3] = __uint_as_float(__byte_perm(l, 0x43000000u, 0x7344));
  hi[0] = __uint_as_float(__byte_perm(h, 0x43000000u, 0x7044));
  hi[1] = __uint_as_float(__byte_perm(h, 0x43000000u, 0x7144));
  hi[2] = __uint_as_float(__byte_perm(h, 0x43000000u, 0x7244));
  hi[3] = __uint_as_float(__byte_perm(h, 0x43000000u, 0x7344));
}

// four consecutive elements of the ring as f32
__device__ __forceinline__ float4 quad(const int8_t* p) {
  return i8x4_f32(*reinterpret_cast<const uint32_t*>(p));
}
__device__ __forceinline__ float4 quad(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}
__device__ __forceinline__ float4 quad(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 16 bytes, of which the first `bytes` are copied and the rest zero-filled
__device__ __forceinline__ void cp_async16_part(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

// at most stages - 2 of this thread's commit groups still in flight (the
// copies of the tile about to be computed have landed)
__device__ __forceinline__ void wait_ring(int stages) {
  if (stages >= 4)
    cp_async_wait<2>();
  else if (stages == 3)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

template <int B> struct RawOf;
template <> struct RawOf<1> { using T = uint8_t; };
template <> struct RawOf<2> { using T = uint16_t; };
template <> struct RawOf<4> { using T = uint32_t; };

// n elements of a 16-byte chunk from src to dst (src in bounds for them),
// the rest of the chunk zeroed (all of it where n <= 0: src is not read);
// vec: one cp.async (src 16-byte aligned), else element by element
template <typename TKV>
__device__ __forceinline__ void copy_chunk(TKV* dst, const TKV* src, int n, bool vec) {
  constexpr int P = 16 / sizeof(TKV);
  using Raw = typename RawOf<sizeof(TKV)>::T;
  if (n <= 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else if (vec) {
    cp_async16_part(dst, src, min(n, P) * static_cast<int>(sizeof(TKV)));
  } else {
    const Raw* s = reinterpret_cast<const Raw*>(src);
    Raw* d = reinterpret_cast<Raw*>(dst);
#pragma unroll
    for (int i = 0; i < P; ++i) d[i] = i < n ? s[i] : Raw(0);
  }
}

template <int NP>
__device__ __forceinline__ void copy_scales(float* dst, const float* src, long long sp, int Tg,
                                            int nv, int t, int threads, bool vec) {
  const int nch = (nv + 3) >> 2;
  for (int c = t; c < NP * nch; c += threads) {
    const int r = NP > 1 && c >= nch, cc = c - r * nch;
    copy_chunk(dst + r * Tg + 4 * cc, src + r * sp + 4 * cc, nv - 4 * cc, vec);
  }
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// A row group's shared memory: `stages` ring stages [K (kr x dk rows of Tg
// columns, 16-byte chunks swizzled by row) | V (Tg x dvp; vt: round4(dv)
// channel rows of vcs = round16(Tg elt) bytes) | ks (np x Tg f32) | vs (np x
// Tg f32)], then q (dk f32) and each warp's p * vs (np x Tw f32). kr: key
// runs a d row, np: positions a column (both 1 for K1 and the selector).
// A warp's Tw columns hold 32 bytes of keys a d row of narrow rows, 8 of
// wide ones (K8: as many packed columns, twice the positions); at least 4.
// After the stream the warps' partials (m, l, pad, pad, acc[dv]) reuse the
// ring, warp w's at w * part (a stage's value tile alone is wr * Tw * dv
// elements, >= 8 * wr * dv bytes).
struct Layout {
  int Tw, Tg, dvp, vcs, v_off, ks_off, vs_off, stage, q_off, p_off, part, group;
  __host__ __device__ Layout(int elt, int qpl, int dk, int dv, int wr, int stages, int kr = 1,
                             int np = 1, bool vt = false) {
    Tw = (qpl == 1 ? 32 : 8) / elt;
    if (Tw < 4) Tw = 4;
    Tg = wr * Tw;
    const int P = 16 / elt;
    dvp = (dv + P - 1) / P * P;
    vcs = round16(Tg * elt);
    v_off = round16(kr * dk * Tg * elt);
    ks_off = v_off + (vt ? ((dv + 3) & ~3) * vcs : round16(Tg * dvp * elt));
    vs_off = ks_off + 4 * np * Tg;
    stage = round16(vs_off + 4 * np * Tg);
    q_off = stages * stage;
    p_off = q_off + round16(4 * dk);
    part = 16 + round16(4 * dv);
    group = p_off + wr * round16(4 * np * Tw);
  }
};

// S counts columns (K8: packed columns); k_sp, ks_sp, vs_sp are K8's
// second key run (FMT_MIXED) and parity strides
struct Args {
  const void* q;
  const void* kt;
  const float* ks;
  const void* v;
  const float* vs;
  const int* lengths;
  void* out;
  float* mo;
  float* lo;
  long long q_se, kt_se, kt_sd, v_se, v_ss, ks_se, vs_se, k_sp, ks_sp, vs_sp;
  int E, dk, S, dv, scalar_len;
  int rows, wr, split, stages;  // rows a CTA, warps a row, CTAs a row, ring depth
  int kvec, vvec, vflat, ksvec, vsvec;  // 16-byte copies allowed; packed value rows
};

// the generic address of p in the shared memory of cluster CTA `rank`
template <typename T>
__device__ __forceinline__ const T* cluster_map(const T* p, int rank) {
  uint64_t r;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(r) : "l"(p), "r"(rank));
  return reinterpret_cast<const T*>(r);
}

// the threads of row group `id` (1-based named barrier; one warp: a warp sync)
__device__ __forceinline__ void group_sync(int id, int threads) {
  if (threads == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// acc += p * v over the warp's positions ps0, ps0 + PS, ... < nv: quads
// j = 0 .. QPL - 1 of the lane at columns 4 (lq + LP j) (GUARD: those at or
// past dv / 4 skipped)
template <int QPL, bool GUARD, typename TKV>
__device__ __forceinline__ void values(float (&acc)[QPL][4], const TKV* Vs, const float* pt,
                                       int ps0, int nv, int PS, int dvp, int LP, int lq,
                                       int Qd) {
#pragma unroll 2
  for (int s = ps0; s < nv; s += PS) {
    const float w = pt[s];
    const TKV* row = Vs + s * dvp;
#pragma unroll
    for (int j = 0; j < QPL; ++j) {
      if (GUARD && lq + LP * j >= Qd) continue;
      const float4 x = quad(row + 4 * LP * j);
      acc[j][0] = fmaf(w, x.x, acc[j][0]);
      acc[j][1] = fmaf(w, x.y, acc[j][1]);
      acc[j][2] = fmaf(w, x.z, acc[j][2]);
      acc[j][3] = fmaf(w, x.w, acc[j][3]);
    }
  }
}

// the same over pair-packed int4 values: column s's word of quad j holds
// 4 channels x (even, odd) positions, weighted by pt[2s], pt[2s + 1]; the
// values carry kNibOff, so wsum gathers the weights for the caller to take
// kNibOff x wsum off
template <int QPL, bool GUARD>
__device__ __forceinline__ void values(float (&acc)[QPL][4], float& wsum, const int8_t* Vs,
                                       const float* pt, int ps0, int nv, int PS, int dvp, int LP,
                                       int lq, int Qd) {
#pragma unroll 2
  for (int s = ps0; s < nv; s += PS) {
    const float2 w = *reinterpret_cast<const float2*>(pt + 2 * s);
    wsum += w.x + w.y;
    const int8_t* row = Vs + s * dvp;
#pragma unroll
    for (int j = 0; j < QPL; ++j) {
      if (GUARD && lq + LP * j >= Qd) continue;
      float lo[4], hi[4];
      nib8(*reinterpret_cast<const uint32_t*>(row + 4 * LP * j), lo, hi);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][k] = fmaf(w.x, lo[k], fmaf(w.y, hi[k], acc[j][k]));
    }
  }
}

// a + the U bytes at p (U / elt elements) times w
template <typename TKV, int U>
__device__ __forceinline__ float unit_dot(const unsigned char* p, const float (&w)[U / sizeof(TKV)],
                                          float a) {
  uint32_t x[U / 4];
  if constexpr (U == 16) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    x[0] = t.x, x[1] = t.y;
  }
#pragma unroll
  for (int i = 0; i < U / 4; ++i) {
    if constexpr (sizeof(TKV) == 1) {
      const float4 f = i8x4_f32(x[i]);
      a = fmaf(w[4 * i], f.x, a);
      a = fmaf(w[4 * i + 1], f.y, a);
      a = fmaf(w[4 * i + 2], f.z, a);
      a = fmaf(w[4 * i + 3], f.w, a);
    } else if constexpr (sizeof(TKV) == 2) {
      a = fmaf(w[2 * i], __uint_as_float(x[i] << 16), a);
      a = fmaf(w[2 * i + 1], __uint_as_float(x[i] & 0xffff0000u), a);
    } else {
      a = fmaf(w[i], __uint_as_float(x[i]), a);
    }
  }
  return a;
}

// acc += p * v over the warp's slice of a channel-major value tile
// (FMT_VT): the slice of a channel row is nu units of U bytes starting at
// byte wb; lane set ps0 takes units ps0, ps0 + PS, ... below the warp's nv
// positions, reads their weights once and a unit of each of its quads'
// channels (GUARD: quads at or past Qd, channels at or past dv skipped). Row
// r holds channel 4 (r % Qd) + r / Qd, its chunk t at t ^ ((r >> vsh) & vm).
template <typename TKV, int QPL, int U, bool GUARD>
__device__ __forceinline__ void values_vt(float (&acc)[QPL][4], const unsigned char* Vb,
                                          const float* pt, int wb, int nu, int ps0, int PS,
                                          int nv, int vcs, int vsh, int vm, int LP, int lq,
                                          int Qd, int dv) {
  constexpr int UP = U / sizeof(TKV);  // positions a unit
  for (int u = ps0; u < nu && u * UP < nv; u += PS) {
    float w[UP];
#pragma unroll
    for (int i = 0; i < UP; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(pt + u * UP + i);
      w[i] = f.x, w[i + 1] = f.y, w[i + 2] = f.z, w[i + 3] = f.w;
    }
    const int b = wb + u * U, t = b >> 4, h = b & 15;
#pragma unroll
    for (int j = 0; j < QPL; ++j) {
      const int qd = lq + LP * j;
      if (GUARD && qd >= Qd) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (GUARD && 4 * qd + k >= dv) continue;
        const int r = k * Qd + qd;
        acc[j][k] =
            unit_dot<TKV, U>(Vb + r * vcs + ((t ^ ((r >> vsh) & vm)) << 4) + h, w, acc[j][k]);
      }
    }
  }
}

// What a row group streams: tiles [first, first + count) of row e, whose n
// columns hold lenp valid positions; keys: whether its keys and ks are read
// (an empty row attending uniformly reads neither).
struct Segment {
  int e, lenp, n, first, count;
  bool keys;
};

// The kernel body's stream. QPL: column quads a lane accumulates (1 for
// narrow rows; 2, 4, 6 or 8 for wider ones, 6 for the Backpack combine's
// 768); Tw, a warp's columns of a group tile, follows from it and the
// element size (K8: 1 byte a column). Row group r_local (wr warps, its
// shared memory at base) streams segment sg through its ring, each warp wi
// its own slice of every tile with its own online softmax; on return each
// warp's partial (m, l, pad, pad, acc[dv]; K8: less the values' offset) lies
// at base + wi * L.part. The caller syncs the group before reading them.
template <typename TQ, typename TKV, int QPL, int FMT>
__device__ __forceinline__ void stream_segment(const Args& a, const Layout& L, unsigned char* base,
                                               const Segment& sg, int r_local, int wi, int gt,
                                               int gthreads) {
  constexpr bool VT = FMT == FMT_VT;
  constexpr int NP = FMT == FMT_K1 || VT ? 1 : 2;  // positions a column
  constexpr int KR = FMT == FMT_MIXED ? 2 : 1;  // key runs a d row
  constexpr int elt = sizeof(TKV);
  constexpr int P = 16 / elt;  // elements a 16-byte chunk
  constexpr int Tw = (QPL == 1 ? 32 : 8) / elt < 4 ? 4 : (QPL == 1 ? 32 : 8) / elt;
  constexpr int PCS = Tw / 4;  // score lanes along the warp's columns
  constexpr int G = 32 / PCS;  // score lanes along dk
  constexpr int U = Tw * elt < 16 ? Tw * elt : 16;  // FMT_VT: bytes a value unit

  const int lane = threadIdx.x & 31;
  const int Tg = L.Tg, KCg = Tg / P;  // columns and key chunks a group tile row
  const int e = sg.e, lenp = sg.lenp, n = sg.n, first = sg.first, count = sg.count;
  const bool keys = sg.keys;

  float* qs = reinterpret_cast<float*>(base + L.q_off);
  float* pt = reinterpret_cast<float*>(base + L.p_off) + wi * (round16(4 * NP * Tw) / 4);
  const TQ* qr = static_cast<const TQ*>(a.q) + e * a.q_se;
  const TKV* ktr = static_cast<const TKV*>(a.kt) + e * a.kt_se;
  const TKV* vr = static_cast<const TKV*>(a.v) + e * a.v_se;
  const float* ksr = a.ks + e * a.ks_se;
  const float* vsr = a.vs + e * a.vs_se;
  // key chunk c of row d lies at chunk c ^ swz(d) of the ring's row
  const int swz_mask = KCg >= 2 ? KCg - 2 : 0;

  const int VCH = L.dvp / P;  // value chunks a position
  const int vq = gthreads / VCH, vrm = gthreads % VCH;
  const int Qd = (a.dv + 3) / 4;  // column quads of dv
  // FMT_VT: 2^kcs chunks a channel row; row r's chunks swizzled by
  // (r >> vsh) & vm, so that 8 consecutive rows spread over a bank period
  const int KCv = L.vcs >> 4, kcs = __ffs(KCv) - 1;
  const int vm = min(KCv, 8) - 1, vsh = KCv >= 8 ? 0 : 3 - kcs;

  auto load = [&](int slot, int tile) {
    unsigned char* st = base + slot * L.stage;
    const int s0 = tile * Tg, nv = min(Tg, n - s0);
    if (keys) {
      TKV* Ks = reinterpret_cast<TKV*>(st);
      for (int i = gt; i < KR * a.dk * KCg; i += gthreads) {
        const int d = i / KCg, c = i % KCg, valid = nv - c * P;
        const int run = KR > 1 && d >= a.dk;  // FMT_MIXED's odd run: rows dk ..
        if (valid > 0)
          copy_chunk(Ks + d * Tg + (c ^ (((d & 3) << 1) & swz_mask)) * P,
                     ktr + (d - run * a.dk) * a.kt_sd + run * a.k_sp + s0 + c * P, valid,
                     a.kvec);
      }
      if (a.ks != nullptr)
        copy_scales<NP>(reinterpret_cast<float*>(st + L.ks_off), ksr + s0, a.ks_sp, Tg, nv, gt,
                        gthreads, a.ksvec);
    }
    if (a.vs != nullptr)
      copy_scales<NP>(reinterpret_cast<float*>(st + L.vs_off), vsr + s0, a.vs_sp, Tg, nv,
                      gthreads - 1 - gt, gthreads, a.vsvec);
    TKV* Vs = reinterpret_cast<TKV*>(st + L.v_off);
    if constexpr (FMT == FMT_VT) {  // channel rows, every chunk of the tile written
      for (int i = gt; i < a.dv << kcs; i += gthreads) {
        const int c = i >> kcs, t = i & (KCv - 1), r = (c & 3) * Qd + (c >> 2);
        copy_chunk(reinterpret_cast<TKV*>(st + L.v_off + r * L.vcs +
                                          ((t ^ ((r >> vsh) & vm)) << 4)),
                   vr + c * a.v_ss + s0 + t * P, nv - t * P, a.vvec);
      }
    } else if (a.vflat) {  // packed rows: the tile is one run of nv * dv elements
      const TKV* src = vr + s0 * a.v_ss;
      for (int i = gt; i < nv * VCH; i += gthreads) cp_async16_part(Vs + i * P, src + i * P, 16);
    } else {
      int s = gt / VCH, c = gt % VCH;
      while (s < nv) {
        copy_chunk(Vs + s * L.dvp + c * P, vr + (s0 + s) * a.v_ss + c * P,
                   a.vvec ? P : min(P, a.dv - c * P), a.vvec);
        s += vq;
        c += vrm;
        if (c >= VCH) c -= VCH, ++s;
      }
    }
  };

  for (int k = 0; k < a.stages - 1; ++k) {
    if (k < count) load(k, first + k);
    cp_async_commit();
  }
  if (count > 0)
    for (int d = gt; d < a.dk; d += gthreads) qs[d] = to_f32(qr[d]);

  // the lane's score columns 4 pc .. 4 pc + 3 of the warp's and dk rows
  // g, g + G, ...; its value quads lq + LP j at columns ps, ps + PS, ...
  const int pc = lane % PCS, g = lane / PCS;
  int LP = 1;
  while (LP < Qd && LP < 32) LP <<= 1;
  const int PS = 32 / LP, lq = lane % LP, ps0 = lane / LP;
  const bool full = a.dv == 4 * QPL * LP;
  const int kcol = (wi * Tw + 4 * pc) * elt;  // the lane's byte in a key row of the tile

  float m = -INFINITY, l = 0.f;
  float koff = 0.f;  // FMT_INT4: the scores' start, -kNibOff x the lane's share of sum q
  float wsum = 0.f;  // K8: the lane's sum of value weights (the values carry kNibOff)
  float acc[QPL][4];
#pragma unroll
  for (int j = 0; j < QPL; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < count; ++i) {
    wait_ring(a.stages);
    group_sync(1 + r_local, gthreads);  // tile i in; every warp done with tile i - 1
    if (i + a.stages - 1 < count) load((i + a.stages - 1) % a.stages, first + i + a.stages - 1);
    cp_async_commit();
    if (FMT == FMT_INT4 && i == 0)
      for (int d = g; d < a.dk; d += G) koff -= kNibOff * qs[d];
    const unsigned char* st = base + (i % a.stages) * L.stage;
    const int sw = (first + i) * Tg + wi * Tw, nv = min(Tw, n - sw);
    if (nv <= 0) continue;  // the warp's share lies past the row's length

    float sc[NP][4];
#pragma unroll
    for (int r = 0; r < NP; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) sc[r][k] = keys ? koff : 0.f;
    if (keys) {
#pragma unroll 4
      for (int d = g; d < a.dk; d += G) {
        const float qd = qs[d];
        const int off = d * Tg * elt + (kcol ^ ((((d & 3) << 1) & swz_mask) << 4));
        if constexpr (NP == 1) {  // FMT_K1, FMT_VT: one int8/bf16/f32 key a column
          const float4 k = quad(reinterpret_cast<const TKV*>(st + off));
          sc[0][0] = fmaf(qd, k.x, sc[0][0]);
          sc[0][1] = fmaf(qd, k.y, sc[0][1]);
          sc[0][2] = fmaf(qd, k.z, sc[0][2]);
          sc[0][3] = fmaf(qd, k.w, sc[0][3]);
        } else if constexpr (FMT == FMT_INT4) {
          float lo[4], hi[4];
          nib8(*reinterpret_cast<const uint32_t*>(st + off), lo, hi);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            sc[0][k] = fmaf(qd, lo[k], sc[0][k]);
            sc[NP - 1][k] = fmaf(qd, hi[k], sc[NP - 1][k]);
          }
        } else {  // FMT_MIXED: the odd positions in row dk + d
          const int d2 = a.dk + d;
          const int off2 = d2 * Tg + (kcol ^ ((((d2 & 3) << 1) & swz_mask) << 4));
          const float4 ke = quad(reinterpret_cast<const int8_t*>(st + off));
          const float4 ko = quad(reinterpret_cast<const int8_t*>(st + off2));
          sc[0][0] = fmaf(qd, ke.x, sc[0][0]);
          sc[0][1] = fmaf(qd, ke.y, sc[0][1]);
          sc[0][2] = fmaf(qd, ke.z, sc[0][2]);
          sc[0][3] = fmaf(qd, ke.w, sc[0][3]);
          sc[NP - 1][0] = fmaf(qd, ko.x, sc[NP - 1][0]);
          sc[NP - 1][1] = fmaf(qd, ko.y, sc[NP - 1][1]);
          sc[NP - 1][2] = fmaf(qd, ko.z, sc[NP - 1][2]);
          sc[NP - 1][3] = fmaf(qd, ko.w, sc[NP - 1][3]);
        }
      }
#pragma unroll
      for (int o = PCS; o < 32; o <<= 1)
#pragma unroll
        for (int r = 0; r < NP; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) sc[r][k] += __shfl_xor_sync(kFull, sc[r][k], o);
      if (a.ks != nullptr)
#pragma unroll
        for (int r = 0; r < NP; ++r) {
          const float4 f = *reinterpret_cast<const float4*>(
              st + L.ks_off + 4 * (r * Tg + wi * Tw + 4 * pc));
          sc[r][0] *= f.x, sc[r][1] *= f.y, sc[r][2] *= f.z, sc[r][3] *= f.w;
        }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * pc + k >= nv) sc[0][k] = -INFINITY;
      // K8: the odd position 2j + 1 of column j
      if (NP > 1 && 2 * (sw + 4 * pc + k) + 1 >= lenp) sc[NP - 1][k] = -INFINITY;
#pragma unroll
      for (int r = 0; r < NP; ++r) mx = fmaxf(mx, sc[r][k]);
    }
#pragma unroll
    for (int o = 1; o < PCS; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    const float m_new = fmaxf(m, mx);
    const float alpha = __expf(m - m_new);
    m = m_new;
    float p[NP][4], psum = 0.f;
#pragma unroll
    for (int r = 0; r < NP; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        p[r][k] = __expf(sc[r][k] - m);
        psum += p[r][k];
      }
    l = l * alpha + (g == 0 ? psum : 0.f);
    if (g == 0) {
      float4 w = make_float4(p[0][0], p[0][1], p[0][2], p[0][3]);
      if constexpr (NP == 1) {
        if (a.vs != nullptr) {
          const float4 f = *reinterpret_cast<const float4*>(st + L.vs_off + 4 * (wi * Tw + 4 * pc));
          w.x *= f.x, w.y *= f.y, w.z *= f.z, w.w *= f.w;
        }
        if (VT) {  // a unit's weights past nv are read: 0, whatever the stale vs
          if (4 * pc >= nv) w.x = 0.f;
          if (4 * pc + 1 >= nv) w.y = 0.f;
          if (4 * pc + 2 >= nv) w.z = 0.f;
          if (4 * pc + 3 >= nv) w.w = 0.f;
        }
        *reinterpret_cast<float4*>(pt + 4 * pc) = w;
      } else {  // (even, odd) weights of each column, side by side
        const float* vsr_t = reinterpret_cast<const float*>(st + L.vs_off) + wi * Tw + 4 * pc;
        const float4 fe = *reinterpret_cast<const float4*>(vsr_t);
        const float4 fo = *reinterpret_cast<const float4*>(vsr_t + Tg);
        *reinterpret_cast<float4*>(pt + 8 * pc) =
            make_float4(w.x * fe.x, p[NP - 1][0] * fo.x, w.y * fe.y, p[NP - 1][1] * fo.y);
        *reinterpret_cast<float4*>(pt + 8 * pc + 4) =
            make_float4(w.z * fe.z, p[NP - 1][2] * fo.z, w.w * fe.w, p[NP - 1][3] * fo.w);
      }
    }
    if (alpha < 1.f) {  // warp-uniform: the max moved
#pragma unroll
      for (int j = 0; j < QPL; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][k] *= alpha;
      wsum *= alpha;
    }
    __syncwarp();

    const TKV* Vs = reinterpret_cast<const TKV*>(st + L.v_off) + wi * Tw * L.dvp + 4 * lq;
    if constexpr (VT) {
      const unsigned char* Vb = st + L.v_off;
      if (full)
        values_vt<TKV, QPL, U, false>(acc, Vb, pt, wi * Tw * elt, Tw * elt / U, ps0, PS, nv,
                                      L.vcs, vsh, vm, LP, lq, Qd, a.dv);
      else
        values_vt<TKV, QPL, U, true>(acc, Vb, pt, wi * Tw * elt, Tw * elt / U, ps0, PS, nv,
                                     L.vcs, vsh, vm, LP, lq, Qd, a.dv);
    } else if constexpr (NP == 1) {
      if (full)  // every lane owns QPL quads: no guard on the loads
        values<QPL, false>(acc, Vs, pt, ps0, nv, PS, L.dvp, LP, lq, Qd);
      else
        values<QPL, true>(acc, Vs, pt, ps0, nv, PS, L.dvp, LP, lq, Qd);
    } else {
      const int8_t* V8 = reinterpret_cast<const int8_t*>(Vs);
      if (full)
        values<QPL, false>(acc, wsum, V8, pt, ps0, nv, PS, L.dvp, LP, lq, Qd);
      else
        values<QPL, true>(acc, wsum, V8, pt, ps0, nv, PS, L.dvp, LP, lq, Qd);
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  group_sync(1 + r_local, gthreads);  // the ring is free for the partials

  // the warp's partial: l over its lanes, acc over its position sets (K8:
  // less the values' offset, each lane its own)
  l = warp_sum(l);
#pragma unroll
  for (int j = 0; j < QPL; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (NP > 1) acc[j][k] = fmaf(-kNibOff, wsum, acc[j][k]);
      for (int o = LP; o < 32; o <<= 1) acc[j][k] += __shfl_xor_sync(kFull, acc[j][k], o);
    }
  float* part = reinterpret_cast<float*>(base + wi * L.part);
  if (lane == 0) part[0] = m, part[1] = l;
  if (lane < LP)
#pragma unroll
    for (int j = 0; j < QPL; ++j) {
      const int qd = lq + LP * j;
      if (qd < Qd)
        *reinterpret_cast<float4*>(part + 4 + 4 * qd) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
}

// The C == 1 merge of a group's a.wr warp partials (at p0, ps floats
// apart) in warp order: M and lsum over the warps, the weights exp(m_j - M)
// once in registers, then for each column col of the group's thread gt
// put(col, o, inv): o the weighted sum of the warps' columns, inv = 1 / lsum
// (0 where no position was valid).
template <class Put>
__device__ __forceinline__ void merge_warps(const Args& a, const float* p0, int ps, int gt,
                                            int gthreads, float& M, float& lsum, Put put) {
  float w[kMaxWarps];
#pragma unroll
  for (int j = 0; j < kMaxWarps; ++j)
    if (j < a.wr) M = fmaxf(M, p0[j * ps]);
#pragma unroll
  for (int j = 0; j < kMaxWarps; ++j) {
    w[j] = j < a.wr && p0[j * ps] != -INFINITY ? __expf(p0[j * ps] - M) : 0.f;
    if (j < a.wr) lsum = fmaf(p0[j * ps + 1], w[j], lsum);
  }
  const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
  for (int col = gt; col < a.dv; col += gthreads) {
    float o = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxWarps; ++j)
      if (j < a.wr) o = fmaf(p0[j * ps + 4 + col], w[j], o);
    put(col, o, inv);
  }
}

// The kernel body of K1, K1-ml, the selector and K8: a row group a row,
// whose ring streams the row's valid prefix (with a split, this CTA's run of
// its group tiles); the row's warps (and the CTAs of its cluster) merge in
// (rank, warp) order.
template <typename TQ, typename TKV, int QPL, int FMT>
__device__ __forceinline__ void decode_rows(const Args& a) {
  constexpr bool VT = FMT == FMT_VT;
  constexpr int NP = FMT == FMT_K1 || VT ? 1 : 2;  // positions a column
  constexpr int KR = FMT == FMT_MIXED ? 2 : 1;  // key runs a d row
  constexpr int elt = sizeof(TKV);
  extern __shared__ __align__(16) unsigned char smem[];

  const int warp = threadIdx.x >> 5;
  const Layout L(elt, QPL, a.dk, a.dv, a.wr, a.stages, KR, NP, VT);
  const int Tg = L.Tg;
  const int C = a.split, rank = blockIdx.x % C, rowblock = blockIdx.x / C;
  const int r_local = warp / a.wr, wi = warp % a.wr;
  const int gt = threadIdx.x - r_local * a.wr * 32, gthreads = a.wr * 32;
  const int e = rowblock * a.rows + r_local;
  const bool active = e < a.E;

  const int len = !active ? 0 : a.lengths != nullptr ? a.lengths[e] : a.scalar_len;
  // an empty row attends uniformly over all NP * S positions (K1, K8) or is
  // an empty segment (the (m, l) form); lenp positions are valid, n columns
  // hold them
  const bool empty = len <= 0;
  const int lenp = !active ? 0 : empty ? (a.mo != nullptr ? 0 : NP * a.S) : min(len, NP * a.S);
  const int n = (lenp + NP - 1) / NP;
  const int nt = (n + Tg - 1) / Tg, tc = (nt + C - 1) / C;
  const int first = rank * tc, count = max(0, min(nt, first + tc) - first);

  unsigned char* base = smem + r_local * L.group;
  // an empty row reads no key and no ks
  stream_segment<TQ, TKV, QPL, FMT>(a, L, base, Segment{e, lenp, n, first, count, !empty}, r_local,
                                    wi, gt, gthreads);
  if (C > 1)
    cluster_sync();
  else
    group_sync(1 + r_local, gthreads);

  // each row group merges its row's C x wr partials in (rank, warp) order:
  // without a cluster, the weights exp(m_j - M) once in registers, then the
  // row's columns; with one, the cluster's groups share the columns, a
  // thread holding at most a few
  if (active) {
    const float* p0 = reinterpret_cast<const float*>(base);
    const int ps = L.part / 4;  // floats between two warps' partials
    TQ* orow = static_cast<TQ*>(a.out) + static_cast<long long>(e) * a.dv;
    float M = -INFINITY, lsum = 0.f;
    if (C == 1) {
      merge_warps(a, p0, ps, gt, gthreads, M, lsum,
                  [&](int col, float o, float inv) { orow[col] = from_f32<TQ>(o * inv); });
    } else {  // few columns a thread: l and o together, a weight each
      const int J = C * a.wr;
      auto part_of = [&](int j) { return cluster_map(p0 + (j % a.wr) * ps, j / a.wr); };
      for (int j = 0; j < J; ++j) M = fmaxf(M, part_of(j)[0]);
      for (int col = rank * gthreads + gt; col < a.dv; col += C * gthreads) {
        float o = 0.f;
        lsum = 0.f;
        for (int j = 0; j < J; ++j) {
          const float* pj = part_of(j);
          const float w = pj[0] == -INFINITY ? 0.f : __expf(pj[0] - M);
          lsum = fmaf(pj[1], w, lsum);
          o = fmaf(pj[4 + col], w, o);
        }
        orow[col] = from_f32<TQ>(lsum > 0.f ? o / lsum : 0.f);
      }
    }
    // (m, l) from the thread that holds column 0
    if (a.mo != nullptr && rank == 0 && gt == 0) {
      a.mo[e] = lsum > 0.f ? M : kNeg;
      a.lo[e] = lsum;
    }
  }
  if (C > 1) cluster_sync();  // the partials stay until every CTA has read them
}

// Check the schedule against the kernel, then launch Kern (a __global__
// wrapper of decode_rows over format fmt) on a grid of ceil(E / rows) x
// split CTAs: a plain launch, or a cluster of `split` CTAs a row.
template <auto Kern>
cudaError_t launch_rows(const Args& a, int elt, int qpl, int fmt, cudaStream_t st) {
  const Layout L(elt, qpl, a.dk, a.dv, a.wr, a.stages, fmt == FMT_MIXED ? 2 : 1,
                 fmt == FMT_INT4 || fmt == FMT_MIXED ? 2 : 1, fmt == FMT_VT);
  if ((L.Tg * elt) % 16) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(a.rows) * L.group;
  if (smem > 232448) return cudaErrorInvalidValue;
  // a block's whole shared memory, once a device: the schedule's launches differ
  cudaError_t err = allow_smem<Kern>(232448);
  if (err != cudaSuccess) return err;
  const unsigned grid =
      static_cast<unsigned>((a.E + a.rows - 1) / a.rows) * static_cast<unsigned>(a.split);
  const dim3 block(static_cast<unsigned>(a.rows * a.wr * 32));
  auto kernel = Kern;
  if (a.split == 1) {  // a plain launch (a cluster launch costs the host more)
    kernel<<<grid, block, smem, st>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = static_cast<unsigned>(a.split);  // a row's CTAs
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

// the schedule's limits, common to both entries: `warps` a CTA over `rows`
// rows (a power of two a row), `split` CTAs a row, 2-4 stages, and dv
// within the lanes' qpl quads
bool schedule_ok(long long warps, long long rows, long long split, long long stages,
                 long long dk, long long dv, long long qpl) {
  const long long wr = rows > 0 ? warps / rows : 0;
  return warps >= 1 && warps <= kMaxWarps && rows >= 1 && warps % rows == 0 &&
         (wr & (wr - 1)) == 0 && split >= 1 && split <= kMaxSplit && stages >= 2 &&
         stages <= 4 && dk >= 1 && dv >= 4 && dv % 4 == 0 && dv <= 128 * qpl;
}

bool aligned(const void* p, long long bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

// The C entries over one element type's caches, K1's (decode_attention.cu:
// FMT_K1, values (E, S, dv)), K1-gathered's (decode_attention_gathered.cu:
// FMT_K1) and the selector's (decode_attention_selector.cu: FMT_VT, values
// (E, dv, S), v_ss the channel stride, any dv): the checks, Args and the
// dtype switch; launch.run<TQ, TKV>(a, qpl, stream) launches the source's
// instance.
template <class Launch>
int k1_entry(const Launch& launch, int fmt, const void* q, const void* kt, const void* ks, const void* v,
             const void* vs, const void* lengths, void* out, void* mo, void* lo, long long E,
             long long dk, long long S, long long dv, long long scalar_len, long long q_se,
             long long kt_se, long long kt_sd, long long v_se, long long v_ss, long long ks_se,
             long long vs_se, long long q_dtype, long long kv_dtype, long long qpl,
             long long warps, long long rows, long long split, long long stages, void* stream) {
  const bool vt = fmt == FMT_VT;
  if (!schedule_ok(warps, rows, split, stages, dk, vt ? (dv + 3) / 4 * 4 : dv, qpl) ||
      (mo == nullptr) != (lo == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0) return 0;
  const long long elt = kv_dtype == DT_I8 ? 1 : kv_dtype == DT_BF16 ? 2 : 4;
  const long long P = 16 / elt;
  Args a;
  a.q = q, a.kt = kt, a.ks = static_cast<const float*>(ks), a.v = v;
  a.vs = static_cast<const float*>(vs), a.lengths = static_cast<const int*>(lengths);
  a.out = out, a.mo = static_cast<float*>(mo), a.lo = static_cast<float*>(lo);
  a.q_se = q_se, a.kt_se = kt_se, a.kt_sd = kt_sd, a.v_se = v_se, a.v_ss = v_ss;
  a.ks_se = ks_se, a.vs_se = vs_se, a.k_sp = a.ks_sp = a.vs_sp = 0;
  a.E = static_cast<int>(E), a.dk = static_cast<int>(dk), a.S = static_cast<int>(S);
  a.dv = static_cast<int>(dv), a.scalar_len = static_cast<int>(scalar_len);
  a.rows = static_cast<int>(rows), a.wr = static_cast<int>(warps / rows);
  a.split = static_cast<int>(split), a.stages = static_cast<int>(stages);
  a.kvec = aligned(kt, 16) && kt_se % P == 0 && kt_sd % P == 0;
  // FMT_VT: a channel row is its own run, so dv takes no part
  a.vvec = aligned(v, 16) && v_se % P == 0 && v_ss % P == 0 && (vt || dv % P == 0);
  a.vflat = !vt && a.vvec && v_ss == dv;
  a.ksvec = ks == nullptr || (aligned(ks, 16) && ks_se % 4 == 0);
  a.vsvec = vs == nullptr || (aligned(vs, 16) && vs_se % 4 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == DT_BF16 && kv_dtype == DT_I8)
    err = launch.template run<__nv_bfloat16, int8_t>(a, qpl, st);
  else if (q_dtype == DT_BF16 && kv_dtype == DT_BF16)
    err = launch.template run<__nv_bfloat16, __nv_bfloat16>(a, qpl, st);
  else if (q_dtype == DT_F32 && kv_dtype == DT_I8)
    err = launch.template run<float, int8_t>(a, qpl, st);
  else if (q_dtype == DT_F32 && kv_dtype == DT_F32)
    err = launch.template run<float, float>(a, qpl, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
