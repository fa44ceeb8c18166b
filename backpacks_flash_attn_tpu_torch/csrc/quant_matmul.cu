// K2: weight-only INT8/INT4 GEMM with the dequantization fused in.
//
// Replaces the TPU kernel backpacks_flash_attn_tpu/ops/quant.py quant_matmul
// (:161, Pallas body _qmm_kernel :130): out = x @ dequant(q, scale) [+ bias],
// where x is bf16 (M, K), q is int8 (K, N) or INT4 packed (K/2, N) (two
// consecutive K rows per byte, low nibble = even row), scale is f32
// (groups, N) over K-groups and out is bf16 (M, n_valid), n_valid <= N.
//
// What bounds it on the H100, and the design's answer:
// - Decode (M = batch = 128): by bytes, the weights (1 a parameter, 0.5 for
//   INT4) over 3.35 TB/s; in practice, for all but the lm-head, the launch,
//   one round trip to memory and the tail (a few microseconds against a
//   bound below one), and for the lm-head the x tile that each 128-column
//   slab re-reads from L2 (2x the weight bytes). One CTA takes all 128 rows,
//   so every weight byte leaves device memory once; the columns are cut into
//   slabs of 128 where those alone fill the card (the lm-head), else 64 or
//   32, and K into chunks (the split, from ops/quant.py _k2_schedule) so
//   that every decode shape launches at least 132 CTAs. A split's chunks of
//   one tile run as one thread-block cluster: each writes its f32 partial to
//   the workspace the wrapper allocates, and after a cluster barrier each
//   sums its share of the tile's rows over the chunks in chunk order (no
//   atomics: two calls give the same bits) and runs the epilogue.
// - Prefill (M = 4096): the products on mma.sync (not wgmma), and L2: every
//   column slab re-reads its x tiles. 128 x 128 tiles, no split; the grid
//   walks M fastest so that a weight slab stays in L2 while its row tiles
//   pass.
// - The weights cross to the SM as int8 (INT4: packed bytes) through a
//   4-stage cp.async ring (16 bytes a thread, the x tile beside them); one
//   __syncthreads a 64-deep slice. B fragments come out of shared memory with
//   ldmatrix.trans on the int8 bytes read as 16-bit pairs: a lane receives
//   columns 2c and 2c + 1 of two K rows, so each 16-column group runs as two
//   m16n8k16 products over its even and its odd columns, and a lane ends up
//   owning 4 adjacent output columns. INT4 bytes hold K rows 4t..4t+3 of a
//   lane, so its x fragments are read with the same K permutation.
//   Per-channel scales (groups == 1): the int8 -> bf16 conversion is exact
//   (an f32 magic-number add; INT4 a bf16 one) and the scale multiplies the
//   f32 sum in the epilogue. Grouped scales: each weight is q * scale in f32,
//   rounded to bf16 before the product, as the plain version and the TPU
//   kernel dequantize.
// - Epilogue: scale, round to bf16, then the optional bias in f32 and round
//   again (ops/quant.py quant_linear's eager form, bit for bit). The tile is
//   staged in shared memory and leaves in 16-byte row stores where the row
//   is 16-byte aligned, in 4- or 2-byte stores along the row where it is not
//   (an odd n_valid, the lm-head's 50257).
#include "common.cuh"

namespace {

constexpr int BM = 128, BK = 64, kThreads = 256, kStages = 4;
constexpr int kMaxSplits = 8;  // a split's chunks form one (portable) cluster

template <int BITS, int BN>
struct Layout {
  // bf16 elements per x row: 144 bytes (ldmatrix rows on distinct banks) for
  // INT8, 160 (64-bit fragment loads on distinct banks a half-warp) for INT4
  static constexpr int A_LD = BITS == 8 ? BK + 8 : BK + 16;
  static constexpr int B_ROWS = BITS == 8 ? BK : BK / 2;  // byte rows a slice
  static constexpr int B_LD = BN + 16;                     // bytes a weight row
  static constexpr int A_BYTES = BM * A_LD * 2;
  static constexpr int STAGE = A_BYTES + B_ROWS * B_LD;
  static constexpr int SMEM = kStages * STAGE;
  static constexpr int OUT_LD = BN + 8;                    // staged bf16 tile
  static_assert(BM * OUT_LD * 2 <= SMEM, "the output tile reuses the ring");
  static_assert(STAGE % 16 == 0, "16-byte aligned stages");
};

__device__ __forceinline__ void ldsm_x1_trans(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
               : "=r"(r[0]) : "r"(s));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(s));
}

// byte SEL of rx (= r ^ 0x80808080, i.e. the int8 value + 128) as an exact
// f32: 2^23 + u minus 2^23 + 128
template <int SEL>
__device__ __forceinline__ float i8_f32(uint32_t rx) {
  return __uint_as_float(__byte_perm(rx, 0x4B000000u, 0x7540 | SEL)) - 8388736.f;
}

// two small integers held exactly in f32 -> their bf16 pair {lo, hi}: the
// upper halves (the lower ones are zero)
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// the two nibbles of byte SEL of r as an exact bf16 pair {low, high}:
// 0x4300 | (nibble ^ 8) is 128 + nibble + 8 in bf16
template <int SEL>
__device__ __forceinline__ uint32_t i4_bf16x2(uint32_t lo, uint32_t hi) {
  const uint32_t v =
      (__byte_perm(lo, hi, ((4 + SEL) << 12) | ((4 + SEL) << 8) | (SEL << 4) | SEL) &
       0x00FF00FFu) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t scaled(uint32_t w, float s_lo, float s_hi) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  return pack_bf16x2(f.x * s_lo, f.y * s_hi);
}

struct Epilogue {
  const float* scale;  // per-channel scales (groups == 1), else null
  const void* bias;    // null, f32 or bf16 (bias_bf16)
  int bias_bf16;
};

// a sum of column n -> bf16: the per-channel scale, round, then the bias in
// f32 and round again
__device__ __forceinline__ __nv_bfloat16 finish(const Epilogue& e, float acc, float sc,
                                                int n) {
  __nv_bfloat16 y = __float2bfloat16_rn(acc * sc);
  if (e.bias != nullptr) {
    const float b = e.bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(e.bias)[n])
                                : static_cast<const float*>(e.bias)[n];
    y = __float2bfloat16_rn(__bfloat162float(y) + b);
  }
  return y;
}

// one staged row segment (ncols bf16 from shared memory) to out_row, lanes
// along the row: 16-byte stores if the destination is 16-byte aligned, else
// 4-byte pairs if 4-byte aligned, else 2-byte stores
__device__ __forceinline__ void store_row(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int ncols, int lane) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(dst);
  if ((a & 15) == 0) {
    for (int c = lane * 8; c < ncols; c += 256) {
      if (c + 8 <= ncols) {
        *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<const uint4*>(src + c);
      } else {
        for (int i = c; i < ncols; ++i) dst[i] = src[i];
      }
    }
  } else if ((a & 3) == 0) {
    for (int c = lane * 2; c < ncols; c += 64) {
      if (c + 2 <= ncols) {
        *reinterpret_cast<uint32_t*>(dst + c) = *reinterpret_cast<const uint32_t*>(src + c);
      } else {
        dst[c] = src[c];
      }
    }
  } else {
    for (int c = lane; c < ncols; c += 32) dst[c] = src[c];
  }
}

// The four k16 steps of one 64-deep slice: x rows [wr, wr + 16 MT) of As
// (bf16, a_ld elements a row, K from column 0 = k0) times the weight slice
// Bs (b_ld bytes a row) at the warp's columns [wc, wc + 16 NJ).
template <int BITS, bool GROUPED, int MT, int NJ>
__device__ __forceinline__ void slice_mma(float (&acc)[MT][2 * NJ][4],
                                          const __nv_bfloat16* __restrict__ As, int a_ld,
                                          const unsigned char* __restrict__ Bs, int b_ld, int wr,
                                          int wc, int lane, int k0,
                                          const float* __restrict__ scale, int N, int n0, int K,
                                          int group_size) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    // B: NJ 16-column groups -> bf16 fragments b[j][even/odd columns][k half]
    uint32_t b[NJ][2][2];
    if constexpr (BITS == 8) {
      uint32_t r[2 * NJ];  // matrix (j, k half) -> r[2 j + half]
      const unsigned char* p =
          Bs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * b_ld + wc;
      if constexpr (NJ == 1) {
        ldsm_x2_trans(r, p);
      } else {
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp)
          ldmatrix_x4_trans(r + 4 * jp, p + (2 * jp + (lane >> 4)) * 16);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t rx = r[2 * j + h] ^ 0x80808080u;
          b[j][0][h] = pack_exact(i8_f32<0>(rx), i8_f32<2>(rx));
          b[j][1][h] = pack_exact(i8_f32<1>(rx), i8_f32<3>(rx));
        }
    } else {
      uint32_t r[NJ];  // matrix j: 8 packed rows (16 K rows) x 16 columns
      const unsigned char* p = Bs + (kk * 8 + (lane & 7)) * b_ld + wc;
      if constexpr (NJ == 1)
        ldsm_x1_trans(r, p);
      else if constexpr (NJ == 2)
        ldsm_x2_trans(r, p + ((lane >> 3) & 1) * 16);
      else
        ldmatrix_x4_trans(r, p + (lane >> 3) * 16);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const uint32_t v = r[j] ^ 0x88888888u;
        const uint32_t lo = v & 0x0F0F0F0Fu, hi = (v >> 4) & 0x0F0F0F0Fu;
        b[j][0][0] = i4_bf16x2<0>(lo, hi);
        b[j][0][1] = i4_bf16x2<2>(lo, hi);
        b[j][1][0] = i4_bf16x2<1>(lo, hi);
        b[j][1][1] = i4_bf16x2<3>(lo, hi);
      }
    }
    if constexpr (GROUPED) {
      // K rows of fragment half h, element e: INT8 h*8 + 2t + e, INT4 4t + 2h + e
      const int kb = k0 + kk * 16;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int grp[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          grp[e] = min(kb + (BITS == 8 ? h * 8 + 2 * t + e : 4 * t + 2 * h + e), K - 1) /
                   group_size;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = n0 + wc + 16 * j + 2 * g;
          const float2 s0 = *reinterpret_cast<const float2*>(
              scale + static_cast<long long>(grp[0]) * N + col);
          const float2 s1 = *reinterpret_cast<const float2*>(
              scale + static_cast<long long>(grp[1]) * N + col);
          b[j][0][h] = scaled(b[j][0][h], s0.x, s1.x);
          b[j][1][h] = scaled(b[j][1][h], s0.y, s1.y);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int row = wr + mi * 16;
      uint32_t a[4];
      if constexpr (BITS == 8) {
        ldmatrix_x4(a, As + (row + (lane & 15)) * a_ld + kk * 16 + (lane >> 4) * 8);
      } else {
        // K permuted as the INT4 bytes are: a lane's K columns 4t..4t+3
        const uint2 lo =
            *reinterpret_cast<const uint2*>(As + (row + g) * a_ld + kk * 16 + 4 * t);
        const uint2 hi =
            *reinterpret_cast<const uint2*>(As + (row + g + 8) * a_ld + kk * 16 + 4 * t);
        a[0] = lo.x, a[1] = hi.x, a[2] = lo.y, a[3] = hi.y;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        mma_16816(acc[mi][2 * j], a, b[j][0]);
        mma_16816(acc[mi][2 * j + 1], a, b[j][1]);
      }
    }
  }
}

// One BM x BN tile of out; with a split (gridDim.z chunks of K, one cluster
// along z), the tile of one chunk. 8 warps as WM (rows) x 8/WM (columns); a
// warp owns MT m16 tiles x NJ 16-column groups, two n8 products each.
template <int BITS, bool GROUPED, int BN>
__global__ void __launch_bounds__(kThreads, GROUPED && BN == 128 ? 1 : 2)  // no spills
quant_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ ws, Epilogue epi, int M, int K, int N, int n_valid,
                    int group_size, int chunk) {
  using L = Layout<BITS, BN>;
  constexpr int WM = BN == 32 ? 4 : 2;  // warp tiles of 64 x 32, 64 x 16, 32 x 16
  constexpr int WN = 8 / WM;
  constexpr int MT = BM / WM / 16;   // m16 tiles a warp
  constexpr int NJ = BN / WN / 16;   // 16-column groups a warp
  static_assert(MT >= 1 && NJ >= 1 && (NJ == 1 || NJ == 2 || NJ == 4), "warp tile");
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * chunk;
  const int kend = min(K, kbeg + chunk);
  const int nslices = (kend - kbeg + BK - 1) / BK;
  const int wr = wm * (BM / WM);  // the warp's first row in the tile
  const int wc = wn * (BN / WN);  // and its first column

  auto a_tile = [&](int stage) {
    return reinterpret_cast<__nv_bfloat16*>(smem + stage * L::STAGE);
  };
  auto b_tile = [&](int stage) { return smem + stage * L::STAGE + L::A_BYTES; };

  // one slice: x rows [m0, m0 + BM) x K [k0, k0 + BK) and its weight rows.
  // x past kend (a chunk's last 32 rows of K) is zero, so that every slice
  // runs its four k16 steps; weight rows past kend keep stale bytes (finite
  // values times zero). x rows past M are not loaded: their sums are never
  // stored. A thread's 16-byte chunks sit at the same place in every slice,
  // so their addresses are worked out once.
  constexpr int PACK = BITS == 8 ? 1 : 2;
  constexpr int A_CPR = BK / 8, A_ITERS = BM * A_CPR / kThreads;  // chunks a row, a thread
  constexpr int B_CPR = BN / 16, B_STEP = kThreads / B_CPR;       // rows between a thread's chunks
  constexpr int B_ITERS = (L::B_ROWS + B_STEP - 1) / B_STEP;
  const int a_c = (tid % A_CPR) * 8, a_r = tid / A_CPR;
  const int b_c = (tid % B_CPR) * 16, b_r = tid / B_CPR;
  const __nv_bfloat16* a_src = x + static_cast<long long>(m0 + a_r) * K + kbeg + a_c;
  const int8_t* b_src = q + (static_cast<long long>(kbeg / PACK) + b_r) * N + n0 + b_c;
  auto load_slice = [&](int slice, int stage) {
    const int k0 = kbeg + slice * BK;
    __nv_bfloat16* As = a_tile(stage) + a_r * L::A_LD + a_c;
    const __nv_bfloat16* ga = a_src + slice * BK;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int r = i * (kThreads / A_CPR);
      if (k0 + a_c >= kend)
        *reinterpret_cast<uint4*>(As + r * L::A_LD) = make_uint4(0u, 0u, 0u, 0u);
      else if (m0 + a_r + r < M)
        cp_async16(As + r * L::A_LD, ga + static_cast<long long>(r) * K);
    }
    unsigned char* Bs = b_tile(stage) + b_r * L::B_LD + b_c;
    const int8_t* gb = b_src + static_cast<long long>(slice) * (BK / PACK) * N;
    const int rows = min(kend - k0, BK) / PACK;
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i) {
      const int r = i * B_STEP;
      if (b_r + r < rows) cp_async16(Bs + r * L::B_LD, gb + static_cast<long long>(r) * N);
    }
  };

  float acc[MT][2 * NJ][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nslices) load_slice(s, s);
    cp_async_commit();
  }

  for (int it = 0; it < nslices; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int nxt = it + kStages - 1;
      if (nxt < nslices) load_slice(nxt, nxt % kStages);
      cp_async_commit();
    }
    slice_mma<BITS, GROUPED, MT, NJ>(acc, a_tile(it % kStages), L::A_LD, b_tile(it % kStages),
                                     L::B_LD, wr, wc, lane, kbeg + it * BK, scale, N, n0, K,
                                     group_size);
  }
  cp_async_wait<0>();

  // a lane holds, for m16 tile mi and group j, rows g and g + 8 x columns
  // 4t..4t+3 of the group: {even[0], odd[0], even[1], odd[1]} and [2], [3]
  __nv_bfloat16* T = reinterpret_cast<__nv_bfloat16*>(smem);  // staged bf16 tile
  int r_lo = 0, r_hi = BM;  // the tile rows this CTA stores
  if (gridDim.z > 1) {
    // the chunk's f32 partial to the workspace; then, the cluster's chunks
    // all written, this CTA sums its share of the tile's rows over the
    // chunks in chunk order
    const int splits = gridDim.z, z = blockIdx.z;
    float* part = ws + static_cast<long long>(z) * M * N;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + wr + mi * 16 + g + 8 * h;
          if (r >= M) continue;
          const int c = n0 + wc + 16 * j + 4 * t;
          *reinterpret_cast<float4*>(part + static_cast<long long>(r) * N + c) =
              make_float4(acc[mi][2 * j][2 * h], acc[mi][2 * j + 1][2 * h],
                          acc[mi][2 * j][2 * h + 1], acc[mi][2 * j + 1][2 * h + 1]);
        }
    cluster_sync();
    const int share = (BM + splits - 1) / splits;
    r_lo = z * share;
    r_hi = min(BM, r_lo + share);
    for (int i = tid; i < (r_hi - r_lo) * (BN / 4); i += kThreads) {
      const int r = r_lo + i / (BN / 4), c = (i % (BN / 4)) * 4;
      if (m0 + r >= M) continue;
      // every chunk's load in flight at once, then the sum in chunk order
      const float* p = ws + static_cast<long long>(m0 + r) * N + n0 + c;
      float4 part_s[kMaxSplits];
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        if (s < splits)
          part_s[s] = *reinterpret_cast<const float4*>(p + static_cast<long long>(s) * M * N);
      float4 sum = part_s[0];
#pragma unroll
      for (int s = 1; s < kMaxSplits; ++s)
        if (s < splits) {
          sum.x += part_s[s].x, sum.y += part_s[s].y;
          sum.z += part_s[s].z, sum.w += part_s[s].w;
        }
      float4 sc = make_float4(1.f, 1.f, 1.f, 1.f);
      if (!GROUPED) sc = *reinterpret_cast<const float4*>(epi.scale + n0 + c);
      const float v[4] = {sum.x, sum.y, sum.z, sum.w}, w[4] = {sc.x, sc.y, sc.z, sc.w};
      __align__(8) __nv_bfloat16 y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = finish(epi, v[e], w[e], min(n0 + c + e, n_valid - 1));
      *reinterpret_cast<uint2*>(T + r * L::OUT_LD + c) = *reinterpret_cast<const uint2*>(y);
    }
  } else {
    __syncthreads();  // every warp is done with the ring
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = wc + 16 * j + 4 * t;
      float sc[4] = {1.f, 1.f, 1.f, 1.f};
      if (!GROUPED) {
        const float4 s4 = *reinterpret_cast<const float4*>(epi.scale + n0 + c);
        sc[0] = s4.x, sc[1] = s4.y, sc[2] = s4.z, sc[3] = s4.w;
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v[4] = {acc[mi][2 * j][2 * h], acc[mi][2 * j + 1][2 * h],
                              acc[mi][2 * j][2 * h + 1], acc[mi][2 * j + 1][2 * h + 1]};
          __align__(8) __nv_bfloat16 y[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)  // the bias past n_valid: never stored
            y[e] = finish(epi, v[e], sc[e], min(n0 + c + e, n_valid - 1));
          *reinterpret_cast<uint2*>(T + (wr + mi * 16 + g + 8 * h) * L::OUT_LD + c) =
              *reinterpret_cast<const uint2*>(y);
        }
    }
  }
  __syncthreads();
  const int ncols = min(BN, n_valid - n0);
  if (ncols <= 0) return;
  for (int r = r_lo + warp; r < r_hi && m0 + r < M; r += kThreads / 32)
    store_row(out + static_cast<long long>(m0 + r) * n_valid + n0, T + r * L::OUT_LD, ncols,
              lane);
}

template <int BITS, bool GROUPED, int BN>
cudaError_t launch_tile(dim3 grid, cudaStream_t st, const __nv_bfloat16* x, const int8_t* q,
                        const float* scale, __nv_bfloat16* out, float* ws, Epilogue epi, int M,
                        int K, int N, int n_valid, int group_size, int chunk) {
  auto kernel = quant_matmul_kernel<BITS, GROUPED, BN>;
  constexpr int smem = Layout<BITS, BN>::SMEM;
  static bool attr[64] = {};  // the shared-memory opt-in, once a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !attr[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (dev < 64) attr[dev] = true;
  }
  if (grid.z == 1) {  // no split: a plain launch (a cluster launch costs the host more)
    kernel<<<grid, kThreads, smem, st>>>(x, q, scale, out, ws, epi, M, K, N, n_valid, group_size,
                                         chunk);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = grid.z;  // a split's chunks form one cluster
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, q, scale, out, ws, epi, M, K, N, n_valid,
                            group_size, chunk);
}

}  // namespace

// out (M, n_valid) bf16 = x (M, K) bf16 @ dequant(q, scale) [+ bias]. The
// schedule comes from ops/quant.py _k2_schedule: bn columns a tile (128, 64
// or 32), K cut into `splits` chunks (at most 8, one cluster) of `chunk`
// rows, a multiple of 64; with splits > 1, ws holds splits x M x N f32.
// bias: null or n_valid values, f32 (bias_dtype 0) or bf16 (1).
extern "C" int quant_matmul_launch(const void* x, const void* q, const void* scale,
                                   const void* bias, long long bias_dtype, void* out, void* ws,
                                   long long M, long long K, long long N, long long n_valid,
                                   long long groups, long long bits, long long bn,
                                   long long splits, long long chunk, void* stream) {
  if ((bits != 8 && bits != 4) || (bn != 32 && bn != 64 && bn != 128) || N % bn || K % 32 ||
      chunk <= 0 || chunk % BK || splits < 1 || splits > kMaxSplits || (splits - 1) * chunk >= K ||
      splits * chunk < K || (splits > 1 && ws == nullptr) || groups < 1 || K % groups ||
      n_valid > N || (bias != nullptr && bias_dtype != DT_F32 && bias_dtype != DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool grouped = groups > 1;
  Epilogue epi{grouped ? nullptr : static_cast<const float*>(scale), bias,
               static_cast<int>(bias_dtype == DT_BF16)};
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), static_cast<unsigned>(N / bn),
                  static_cast<unsigned>(splits));
#define K2_ARGS grid, st, static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q), \
                static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),            \
                static_cast<float*>(ws), epi, static_cast<int>(M), static_cast<int>(K),         \
                static_cast<int>(N), static_cast<int>(n_valid), static_cast<int>(K / groups),   \
                static_cast<int>(chunk)
#define K2_BN(B, G)                                                              \
  (bn == 128 ? launch_tile<B, G, 128>(K2_ARGS)                                   \
             : bn == 64 ? launch_tile<B, G, 64>(K2_ARGS) : launch_tile<B, G, 32>(K2_ARGS))
  cudaError_t e;
  if (bits == 8)
    e = grouped ? K2_BN(8, true) : K2_BN(8, false);
  else
    e = grouped ? K2_BN(4, true) : K2_BN(4, false);
#undef K2_BN
#undef K2_ARGS
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
