// K1: single-query decode attention over (possibly INT8) flat-E caches.
//
// Replaces the TPU kernel backpacks_flash_attn_tpu/ops/decode_attention.py
// decode_attention_fused (:77, Pallas body _kernel :43), whose contract the
// TPU's shipped XLA contraction decode_attention_flat (:134) shares:
//   out[e] = softmax_{s < len[e]}((q[e] . kt[e,:,s]) * ks[e,s]) * vs[e,s] @ v[e,s,:]
// q (E, dk) pre-scaled; kt (E, dk, S) stored transposed; v (E, S, dv); the
// scales (E, S) f32 or absent; any outer strides (window slices of a cache).
//
// Bound on the H100: memory. Each row reads its key prefix (dk x len) and
// value prefix (len x dv) once, at stored precision (int8: 1 byte), plus 8
// bytes of scales a position; the work is ~2 flops per byte, far below the
// card's ~295 flop/byte ridge, so the least time is bytes / 3.35 TB/s.
//
// Design. The warps of a row (a row group) share a cp.async ring in shared
// memory and stream the row's valid prefix in group tiles of Tg positions,
// a tile's keys and values one commit group, the next stages' copies in
// flight while this tile is computed, one named barrier a tile. Warp w of
// the group owns positions [w Tw, (w + 1) Tw) of every group tile and
// keeps its own online softmax (m, l, acc) over them in registers, so the
// warps never wait on each other's arithmetic; the row's partials (and
// with a split, those of the other CTAs of its cluster) merge at the end
// in a fixed order (rank, then warp). There is no score row in shared
// memory (so no cap on S) and no workspace. Only positions below the
// row's length are copied (a chunk straddling the length copies its valid
// bytes and zero-fills the rest).
//   Loads: 16 bytes a copy where the base and strides allow it: a key row
// of a group tile is one contiguous run of Tg * elt bytes (128 or 256 for
// narrow rows; the old 32-byte pieces a warp left DRAM half idle), a
// value tile one run when the rows are packed; otherwise the same launch
// copies element by element (unaligned window slices, dv not a multiple
// of 16 bytes). The 16-byte key chunks are swizzled by row so that the
// score lanes' reads hit distinct banks.
//   Scores: a lane takes 4 of the warp's positions and every G-th d row
// (G = 128 / Tw), reads them from the ring as one 4-, 8- or 16-byte word,
// converts in registers (int8 through __byte_perm into the mantissa of
// 2^23 and one subtraction; bf16 by a shift) and sums in f32; the G lanes
// of a position combine by xor shuffles. ks scales the score, the tile's
// max updates m, exp(s - m) times vs goes to a per-warp row.
//   Values: a lane owns 4-column quads of dv (lane, lane + 32, ... for
// wide rows; for narrow ones LP = pow2(dv / 4) lanes cover a row and the
// 32 / LP lane sets take alternate positions) and accumulates f32.
//   Schedule (ops/decode_attention.py _k1_schedule): narrow rows (dv <=
// 128; Tw = 32 bytes of keys a d row) run 2 rows of 4 warps a CTA, or 1
// row of 8 warps when the rows are fewer than two an SM; wide rows (the
// Backpack combine's dv 768; Tw = 8 bytes, so that a warp's share of the
// ring stays small and 16 warps fit an SM) run one row of 4 warps a CTA;
// when even one row a CTA leaves SMs idle, S is split over a thread-block
// cluster of up to 8 CTAs, each taking a contiguous run of the row's group
// tiles, merged through distributed shared memory after a cluster barrier
// (one launch, a fixed order). The ring's depth (2 to 4 stages) is the
// most that fits as many CTAs an SM as the grid puts there (at most 3).
//
// The old kernel (one 256-thread CTA a row, the score row in shared memory
// with block reductions, keys one byte a thread per d, values 4 a thread,
// the key and value streams in separate phases) capped S at 8192, read one
// row per CTA and left most SMs idle at few rows.
//
// Semantics kept: a row of length <= 0 attends uniformly over all S
// columns (the masked softmax of the reference when every score is NEG):
// its keys are not read, its scores are 0. The (m, l) form (mo, lo
// non-null; counted apart as decode_attention_ml) writes each row's softmax
// state for the staged serving decode, which merges this main segment with
// a short segment over the staging block (merge_softmax_segments,
// decode_attention.py:1270): m = the row max of the valid scores, in the
// units of the scores above, and l = sum exp(s - m) over the same
// positions, so that out * l is the unnormalized segment. A row with no
// valid position returns (0, NEG, 0), as stage_segment_attention does.
#include "common.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxSplit = 8;
constexpr float kNeg = -1e30f;   // decode_attention.py NEG
constexpr unsigned kFull = 0xffffffffu;

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

// n elements of a 16-byte chunk from src to dst (src in bounds for them);
// vec: one cp.async (src 16-byte aligned), else element by element
template <typename TKV>
__device__ __forceinline__ void copy_chunk(TKV* dst, const TKV* src, int n, bool vec) {
  constexpr int P = 16 / sizeof(TKV);
  using Raw = typename RawOf<sizeof(TKV)>::T;
  if (vec) {
    cp_async16_part(dst, src, min(n, P) * static_cast<int>(sizeof(TKV)));
  } else {
    const Raw* s = reinterpret_cast<const Raw*>(src);
    Raw* d = reinterpret_cast<Raw*>(dst);
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (i < n) d[i] = s[i];
  }
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// A row group's shared memory: `stages` ring stages [K (dk x Tg, 16-byte
// chunks swizzled by row) | V (Tg x dvp) | ks (Tg f32) | vs (Tg f32)], then
// q (dk f32) and each warp's p * vs (Tw f32). After the stream the warps'
// partials (m, l, pad, pad, acc[dv]) reuse the ring, warp w's at w * part
// (a stage's value tile alone is wr * Tw * dv elements, >= 8 * wr * dv bytes).
struct Layout {
  int Tw, Tg, dvp, v_off, ks_off, vs_off, stage, q_off, p_off, part, group;
  __host__ __device__ Layout(int elt, int qpl, int dk, int dv, int wr, int stages) {
    Tw = (qpl == 1 ? 32 : 8) / elt;
    if (Tw < 4) Tw = 4;
    Tg = wr * Tw;
    const int P = 16 / elt;
    dvp = (dv + P - 1) / P * P;
    v_off = round16(dk * Tg * elt);
    ks_off = v_off + round16(Tg * dvp * elt);
    vs_off = ks_off + 4 * Tg;
    stage = round16(vs_off + 4 * Tg);
    q_off = stages * stage;
    p_off = q_off + round16(4 * dk);
    part = 16 + round16(4 * dv);
    group = p_off + wr * round16(4 * Tw);
  }
};

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
  long long q_se, kt_se, kt_sd, v_se, v_ss, ks_se, vs_se;
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

// QPL: column quads a lane accumulates (1 for narrow rows; 2, 4, 6 or 8 for
// wider ones, 6 for the Backpack combine's 768); Tw, a warp's positions of a
// group tile, follows from it and the element size.
template <typename TQ, typename TKV, int QPL>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
decode_attention_kernel(const Args a) {
  constexpr int elt = sizeof(TKV);
  constexpr int P = 16 / elt;  // elements a 16-byte chunk
  constexpr int Tw = (QPL == 1 ? 32 : 8) / elt < 4 ? 4 : (QPL == 1 ? 32 : 8) / elt;
  constexpr int PCS = Tw / 4;  // score lanes along the warp's positions
  constexpr int G = 32 / PCS;  // score lanes along dk
  extern __shared__ __align__(16) unsigned char smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Layout L(elt, QPL, a.dk, a.dv, a.wr, a.stages);
  const int Tg = L.Tg, KCg = Tg / P;  // positions and key chunks a group tile row
  const int C = a.split, rank = blockIdx.x % C, rowblock = blockIdx.x / C;
  const int r_local = warp / a.wr, wi = warp % a.wr;
  const int gt = threadIdx.x - r_local * a.wr * 32, gthreads = a.wr * 32;
  const int e = rowblock * a.rows + r_local;
  const bool active = e < a.E;

  const int len = !active ? 0 : a.lengths != nullptr ? a.lengths[e] : a.scalar_len;
  // an empty row attends uniformly over all S columns (K1) or is an empty
  // segment (the (m, l) form)
  const bool empty = len <= 0;
  const int n = !active ? 0 : empty ? (a.mo != nullptr ? 0 : a.S) : min(len, a.S);
  const int nt = (n + Tg - 1) / Tg, tc = (nt + C - 1) / C;
  const int first = rank * tc, count = max(0, min(nt, first + tc) - first);

  unsigned char* base = smem + r_local * L.group;
  float* qs = reinterpret_cast<float*>(base + L.q_off);
  float* pt = reinterpret_cast<float*>(base + L.p_off) + wi * (round16(4 * Tw) / 4);
  const TQ* qr = static_cast<const TQ*>(a.q) + e * a.q_se;
  const TKV* ktr = static_cast<const TKV*>(a.kt) + e * a.kt_se;
  const TKV* vr = static_cast<const TKV*>(a.v) + e * a.v_se;
  const float* ksr = a.ks + e * a.ks_se;
  const float* vsr = a.vs + e * a.vs_se;
  const bool keys = !empty;  // an empty K1 row reads no key and no ks
  // key chunk c of row d lies at chunk c ^ swz(d) of the ring's row
  const int swz_mask = KCg >= 2 ? KCg - 2 : 0;

  const int VCH = L.dvp / P;  // value chunks a position
  const int vq = gthreads / VCH, vrm = gthreads % VCH;

  auto load = [&](int slot, int tile) {
    unsigned char* st = base + slot * L.stage;
    const int s0 = tile * Tg, nv = min(Tg, n - s0);
    if (keys) {
      TKV* Ks = reinterpret_cast<TKV*>(st);
      for (int i = gt; i < a.dk * KCg; i += gthreads) {
        const int d = i / KCg, c = i % KCg, valid = nv - c * P;
        if (valid > 0)
          copy_chunk(Ks + d * Tg + (c ^ (((d & 3) << 1) & swz_mask)) * P,
                     ktr + d * a.kt_sd + s0 + c * P, valid, a.kvec);
      }
      if (a.ks != nullptr)
        for (int c = gt; 4 * c < nv; c += gthreads)
          copy_chunk(reinterpret_cast<float*>(st + L.ks_off) + 4 * c, ksr + s0 + 4 * c,
                     nv - 4 * c, a.ksvec);
    }
    if (a.vs != nullptr)
      for (int c = gthreads - 1 - gt; 4 * c < nv; c += gthreads)
        copy_chunk(reinterpret_cast<float*>(st + L.vs_off) + 4 * c, vsr + s0 + 4 * c,
                   nv - 4 * c, a.vsvec);
    TKV* Vs = reinterpret_cast<TKV*>(st + L.v_off);
    if (a.vflat) {  // packed rows: the tile is one run of nv * dv elements
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

  // the lane's score positions 4 pc .. 4 pc + 3 of the warp's and dk rows
  // g, g + G, ...; its value quads lq + LP j at positions ps, ps + PS, ...
  const int pc = lane % PCS, g = lane / PCS;
  const int Qd = a.dv / 4;
  int LP = 1;
  while (LP < Qd && LP < 32) LP <<= 1;
  const int PS = 32 / LP, lq = lane % LP, ps0 = lane / LP;
  const bool full = Qd == QPL * LP;
  const int kcol = (wi * Tw + 4 * pc) * elt;  // the lane's byte in a key row of the tile

  float m = -INFINITY, l = 0.f;
  float acc[QPL][4];
#pragma unroll
  for (int j = 0; j < QPL; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < count; ++i) {
    wait_ring(a.stages);
    group_sync(1 + r_local, gthreads);  // tile i in; every warp done with tile i - 1
    if (i + a.stages - 1 < count) load((i + a.stages - 1) % a.stages, first + i + a.stages - 1);
    cp_async_commit();
    const unsigned char* st = base + (i % a.stages) * L.stage;
    const int sw = (first + i) * Tg + wi * Tw, nv = min(Tw, n - sw);
    if (nv <= 0) continue;  // the warp's share lies past the row's length

    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    if (keys) {
#pragma unroll 4
      for (int d = g; d < a.dk; d += G) {
        const float qd = qs[d];
        const int off = d * Tg * elt + (kcol ^ ((((d & 3) << 1) & swz_mask) << 4));
        const float4 k = quad(reinterpret_cast<const TKV*>(st + off));
        sc[0] = fmaf(qd, k.x, sc[0]);
        sc[1] = fmaf(qd, k.y, sc[1]);
        sc[2] = fmaf(qd, k.z, sc[2]);
        sc[3] = fmaf(qd, k.w, sc[3]);
      }
#pragma unroll
      for (int o = PCS; o < 32; o <<= 1)
#pragma unroll
        for (int k = 0; k < 4; ++k) sc[k] += __shfl_xor_sync(kFull, sc[k], o);
      if (a.ks != nullptr) {
        const float4 f = *reinterpret_cast<const float4*>(st + L.ks_off + 4 * (wi * Tw + 4 * pc));
        sc[0] *= f.x, sc[1] *= f.y, sc[2] *= f.z, sc[3] *= f.w;
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * pc + k >= nv) sc[k] = -INFINITY;
      mx = fmaxf(mx, sc[k]);
    }
#pragma unroll
    for (int o = 1; o < PCS; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    const float m_new = fmaxf(m, mx);
    const float alpha = __expf(m - m_new);
    m = m_new;
    float p[4], psum = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      p[k] = __expf(sc[k] - m);
      psum += p[k];
    }
    l = l * alpha + (g == 0 ? psum : 0.f);
    if (g == 0) {
      float4 w = make_float4(p[0], p[1], p[2], p[3]);
      if (a.vs != nullptr) {
        const float4 f = *reinterpret_cast<const float4*>(st + L.vs_off + 4 * (wi * Tw + 4 * pc));
        w.x *= f.x, w.y *= f.y, w.z *= f.z, w.w *= f.w;
      }
      *reinterpret_cast<float4*>(pt + 4 * pc) = w;
    }
    if (alpha < 1.f)  // warp-uniform: the max moved
#pragma unroll
      for (int j = 0; j < QPL; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][k] *= alpha;
    __syncwarp();

    const TKV* Vs = reinterpret_cast<const TKV*>(st + L.v_off) + wi * Tw * L.dvp + 4 * lq;
    if (full)  // every lane owns QPL quads: no guard on the loads
      values<QPL, false>(acc, Vs, pt, ps0, nv, PS, L.dvp, LP, lq, Qd);
    else
      values<QPL, true>(acc, Vs, pt, ps0, nv, PS, L.dvp, LP, lq, Qd);
    __syncwarp();
  }
  cp_async_wait<0>();
  group_sync(1 + r_local, gthreads);  // the ring is free for the partials

  // the warp's partial: l over its lanes, acc over its position sets
  l = warp_sum(l);
#pragma unroll
  for (int j = 0; j < QPL; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      for (int o = LP; o < 32; o <<= 1) acc[j][k] += __shfl_xor_sync(kFull, acc[j][k], o);
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
  if (C > 1)
    cluster_sync();
  else
    __syncthreads();

  // merge each row's C x wr partials in (rank, warp) order; the cluster's
  // threads share the rows' columns
  const int J = C * a.wr;
  for (int idx = rank * blockDim.x + threadIdx.x; idx < a.rows * a.dv;
       idx += C * blockDim.x) {
    const int r = idx / a.dv, col = idx - r * a.dv;
    const int row = rowblock * a.rows + r;
    if (row >= a.E) break;
    auto part_of = [&](int j) {
      const float* pj = reinterpret_cast<const float*>(smem + r * L.group + (j % a.wr) * L.part);
      return C > 1 ? cluster_map(pj, j / a.wr) : pj;
    };
    float M = -INFINITY;
    for (int j = 0; j < J; ++j) M = fmaxf(M, part_of(j)[0]);
    float lsum = 0.f, o = 0.f;
    for (int j = 0; j < J; ++j) {
      const float* pj = part_of(j);
      const float w = pj[0] == -INFINITY ? 0.f : __expf(pj[0] - M);
      lsum = fmaf(pj[1], w, lsum);
      o = fmaf(pj[4 + col], w, o);
    }
    static_cast<TQ*>(a.out)[static_cast<long long>(row) * a.dv + col] =
        from_f32<TQ>(lsum > 0.f ? o / lsum : 0.f);
    if (a.mo != nullptr && col == 0) {
      a.mo[row] = lsum > 0.f ? M : kNeg;
      a.lo[row] = lsum;
    }
  }
  if (C > 1) cluster_sync();  // the partials stay until every CTA has read them
}

template <typename TQ, typename TKV, int QPL>
cudaError_t launch(const Args& a, cudaStream_t st) {
  auto kernel = decode_attention_kernel<TQ, TKV, QPL>;
  const Layout L(sizeof(TKV), QPL, a.dk, a.dv, a.wr, a.stages);
  if ((L.Tg * static_cast<int>(sizeof(TKV))) % 16) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(a.rows) * L.group;
  // a block's whole shared memory, once a device: the schedule's launches differ
  cudaError_t err = allow_smem<decode_attention_kernel<TQ, TKV, QPL>>(232448);
  if (err != cudaSuccess) return err;
  const unsigned grid =
      static_cast<unsigned>((a.E + a.rows - 1) / a.rows) * static_cast<unsigned>(a.split);
  const dim3 block(static_cast<unsigned>(a.rows * a.wr * 32));
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

template <typename TQ, typename TKV>
cudaError_t launch_qpl(const Args& a, long long qpl, cudaStream_t st) {
  switch (qpl) {
    case 1: return launch<TQ, TKV, 1>(a, st);
    case 2: return launch<TQ, TKV, 2>(a, st);
    case 4: return launch<TQ, TKV, 4>(a, st);
    case 6: return launch<TQ, TKV, 6>(a, st);
    case 8: return launch<TQ, TKV, 8>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned(const void* p, long long bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

}  // namespace

// The launch shape comes from ops/decode_attention.py _k1_schedule: qpl
// column quads a lane (1, 2, 4, 6 or 8: narrow rows 1), `warps` a CTA, `rows`
// rows a CTA (warps / rows warps a row, a power of two), `split` CTAs a
// row (one cluster, at most 8) and `stages` ring stages (2 to 4).
extern "C" int decode_attention_launch(const void* q, const void* kt, const void* ks,
                                       const void* v, const void* vs, const void* lengths,
                                       void* out, void* mo, void* lo, long long E,
                                       long long dk, long long S,
                                       long long dv, long long scalar_len, long long q_se,
                                       long long kt_se, long long kt_sd, long long v_se,
                                       long long v_ss, long long ks_se, long long vs_se,
                                       long long q_dtype, long long kv_dtype, long long qpl,
                                       long long warps, long long rows, long long split,
                                       long long stages, void* stream) {
  const long long wr = rows > 0 ? warps / rows : 0;
  if (warps < 1 || warps > kMaxWarps || rows < 1 || warps % rows || (wr & (wr - 1)) || split < 1 ||
      split > kMaxSplit || stages < 2 || stages > 4 || dk < 1 || dv < 4 || dv % 4 ||
      dv > 128 * qpl || (mo == nullptr) != (lo == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0) return 0;
  const long long elt = kv_dtype == DT_I8 ? 1 : kv_dtype == DT_BF16 ? 2 : 4;
  const long long P = 16 / elt;
  Args a;
  a.q = q, a.kt = kt, a.ks = static_cast<const float*>(ks), a.v = v;
  a.vs = static_cast<const float*>(vs), a.lengths = static_cast<const int*>(lengths);
  a.out = out, a.mo = static_cast<float*>(mo), a.lo = static_cast<float*>(lo);
  a.q_se = q_se, a.kt_se = kt_se, a.kt_sd = kt_sd, a.v_se = v_se, a.v_ss = v_ss;
  a.ks_se = ks_se, a.vs_se = vs_se;
  a.E = static_cast<int>(E), a.dk = static_cast<int>(dk), a.S = static_cast<int>(S);
  a.dv = static_cast<int>(dv), a.scalar_len = static_cast<int>(scalar_len);
  a.rows = static_cast<int>(rows), a.wr = static_cast<int>(warps / rows);
  a.split = static_cast<int>(split), a.stages = static_cast<int>(stages);
  a.kvec = aligned(kt, 16) && kt_se % P == 0 && kt_sd % P == 0;
  a.vvec = aligned(v, 16) && v_se % P == 0 && v_ss % P == 0 && dv % P == 0;
  a.vflat = a.vvec && v_ss == dv;
  a.ksvec = ks == nullptr || (aligned(ks, 16) && ks_se % 4 == 0);
  a.vsvec = vs == nullptr || (aligned(vs, 16) && vs_se % 4 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == DT_BF16 && kv_dtype == DT_I8)
    err = launch_qpl<__nv_bfloat16, int8_t>(a, qpl, st);
  else if (q_dtype == DT_BF16 && kv_dtype == DT_BF16)
    err = launch_qpl<__nv_bfloat16, __nv_bfloat16>(a, qpl, st);
  else if (q_dtype == DT_F32 && kv_dtype == DT_I8)
    err = launch_qpl<float, int8_t>(a, qpl, st);
  else if (q_dtype == DT_F32 && kv_dtype == DT_F32)
    err = launch_qpl<float, float>(a, qpl, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
