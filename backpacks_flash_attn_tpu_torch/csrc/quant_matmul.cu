// K2: weight-only INT8/INT4 GEMM with the dequantization fused in.
//
// Replaces the TPU kernel backpacks_flash_attn_tpu/ops/quant.py quant_matmul
// (:161, Pallas body _qmm_kernel :130): out = x @ dequant(q, scale), where q
// is int8 (K, N) or INT4 packed (K/2, N) (two consecutive K rows per byte,
// low nibble = even row) and scale is f32 (groups, N) over K-groups.
//
// Bound on the H100: at decode (M = batch = 128) the weight bytes
// (1 byte/param, 0.5 for INT4) over 3.35 TB/s; at prefill (M = batch x
// prompt = 4096) the flops over the bf16 tensor-core rate. Design: one
// 256-thread block per 64 x 128 output tile, a loop over K in 32-deep
// slices. Each slice's weights are read from device memory once as int8
// (16 bytes per thread), dequantized in registers with the group's scale,
// rounded to bf16 exactly as the plain version does, and stored to shared
// memory; the bf16 x slice beside them. Eight warps (2 x 4) each own a
// 32 x 32 sub-tile and run mma.sync m16n8k16 bf16 tensor-core products with
// f32 accumulators in registers. The next slice's global loads are issued
// before the current slice's products (register double buffering). No bf16
// copy of the weight ever reaches device memory.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 128, BK = 32;
constexpr int kThreads = 256;
constexpr int APAD = 8, BPAD = 8;  // bf16 elements of row padding (bank spread)

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// sign-extended low / high nibble of a packed byte
__device__ __forceinline__ int nib_lo(int8_t b) {
  return static_cast<int>(static_cast<uint32_t>(static_cast<uint8_t>(b)) << 28) >> 28;
}
__device__ __forceinline__ int nib_hi(int8_t b) {
  return static_cast<int>(static_cast<uint32_t>(static_cast<uint8_t>(b)) << 24) >> 28;
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M,
                    int K, int N, int n_valid, int group_size) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][BK + APAD];
  __shared__ __align__(16) __nv_bfloat16 Bs[BK][BN + BPAD];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 32 x 32 each
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // A slice: 64 rows x 32 bf16; each thread one 16-byte chunk
  const int a_row = tid >> 2, a_col = (tid & 3) * 8;
  const bool a_ok = m0 + a_row < M;
  const __nv_bfloat16* a_src = x + static_cast<long long>(m0 + a_row) * K + a_col;
  // B slice: 32 K rows x 128 columns of int8 (INT4: 16 packed rows);
  // INT8: thread -> (row tid/8, 16 columns); INT4: (packed row tid/16, 8 columns)
  constexpr int B_COLS = BITS == 8 ? 16 : 8;
  const int b_row = BITS == 8 ? (tid >> 3) : (tid >> 4);
  const int b_col = BITS == 8 ? (tid & 7) * 16 : (tid & 15) * 8;
  const int8_t* b_src = q + static_cast<long long>(b_row) * N + n0 + b_col;
  const long long b_step = static_cast<long long>(BITS == 8 ? BK : BK / 2) * N;

  uint4 a_reg = make_uint4(0u, 0u, 0u, 0u);
  uint4 b_reg = make_uint4(0u, 0u, 0u, 0u);  // INT4 uses the first 8 bytes

  auto load_slice = [&](int k0) {
    if (a_ok) a_reg = *reinterpret_cast<const uint4*>(a_src + k0);
    const int8_t* src = b_src + (k0 / BK) * b_step;
    if constexpr (BITS == 8) {
      b_reg = *reinterpret_cast<const uint4*>(src);
    } else {
      const uint2 r = *reinterpret_cast<const uint2*>(src);
      b_reg.x = r.x;
      b_reg.y = r.y;
    }
  };

  float sc_lo[B_COLS], sc_hi[B_COLS];
  int grp_lo = -1, grp_hi = -1;
  auto store_slice = [&](int k0) {
    *reinterpret_cast<uint4*>(&As[a_row][a_col]) = a_reg;
    const int8_t* bytes = reinterpret_cast<const int8_t*>(&b_reg);
    // K rows this thread fills: INT8 one (b_row), INT4 two (2*b_row, +1)
    const int k_lo = BITS == 8 ? k0 + b_row : k0 + 2 * b_row;
    const int gl = k_lo / group_size;
    if (gl != grp_lo) {
      grp_lo = gl;
      const float* s = scale + static_cast<long long>(gl) * N + n0 + b_col;
#pragma unroll
      for (int i = 0; i < B_COLS; ++i) sc_lo[i] = s[i];
    }
    __align__(16) __nv_bfloat16 w[B_COLS];
    if constexpr (BITS == 8) {
#pragma unroll
      for (int i = 0; i < B_COLS; ++i)
        w[i] = __float2bfloat16(static_cast<float>(bytes[i]) * sc_lo[i]);
#pragma unroll
      for (int i = 0; i < B_COLS; i += 8)
        *reinterpret_cast<uint4*>(&Bs[b_row][b_col + i]) = *reinterpret_cast<uint4*>(&w[i]);
    } else {
      const int gh = (k_lo + 1) / group_size;
      if (gh != grp_hi) {
        grp_hi = gh;
        const float* s = scale + static_cast<long long>(gh) * N + n0 + b_col;
#pragma unroll
        for (int i = 0; i < B_COLS; ++i) sc_hi[i] = s[i];
      }
#pragma unroll
      for (int i = 0; i < B_COLS; ++i)
        w[i] = __float2bfloat16(static_cast<float>(nib_lo(bytes[i])) * sc_lo[i]);
      *reinterpret_cast<uint4*>(&Bs[2 * b_row][b_col]) = *reinterpret_cast<uint4*>(w);
#pragma unroll
      for (int i = 0; i < B_COLS; ++i)
        w[i] = __float2bfloat16(static_cast<float>(nib_hi(bytes[i])) * sc_hi[i]);
      *reinterpret_cast<uint4*>(&Bs[2 * b_row + 1][b_col]) = *reinterpret_cast<uint4*>(w);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  load_slice(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_slice(k0);
    __syncthreads();
    if (k0 + BK < K) load_slice(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * t]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * t]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * t + 8]);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn * 32 + ni * 8 + g;
        bf[ni][0] = pack_bf16(Bs[kk + 2 * t][c], Bs[kk + 2 * t + 1][c]);
        bf[ni][1] = pack_bf16(Bs[kk + 2 * t + 8][c], Bs[kk + 2 * t + 9][c]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = m0 + wm * 32 + mi * 16 + g;
      const int c = n0 + wn * 32 + ni * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + 8 * h;
        if (rr >= M) continue;
        __nv_bfloat16* o = out + static_cast<long long>(rr) * n_valid;
        if (c < n_valid) o[c] = __float2bfloat16(acc[mi][ni][2 * h]);
        if (c + 1 < n_valid) o[c + 1] = __float2bfloat16(acc[mi][ni][2 * h + 1]);
      }
    }
  }
}

}  // namespace

extern "C" int quant_matmul_launch(const void* x, const void* q, const void* scale, void* out,
                                   long long M, long long K, long long N, long long n_valid,
                                   long long groups, long long bits, void* stream) {
  const dim3 grid(static_cast<unsigned>(N / BN), static_cast<unsigned>((M + BM - 1) / BM));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int group_size = static_cast<int>(K / groups);
#define K2_ARGS static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q), \
                static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),  \
                static_cast<int>(M), static_cast<int>(K), static_cast<int>(N),        \
                static_cast<int>(n_valid), group_size
  if (bits == 8)
    quant_matmul_kernel<8><<<grid, kThreads, 0, st>>>(K2_ARGS);
  else if (bits == 4)
    quant_matmul_kernel<4><<<grid, kThreads, 0, st>>>(K2_ARGS);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef K2_ARGS
  return static_cast<int>(cudaGetLastError());
}
