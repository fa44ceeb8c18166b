// Shared helpers of the port's CUDA kernels (sm_90a, built by ops/_build.py).
//
// Every kernel file exposes plain C entry points that take device pointers,
// sizes and strides as integers, launch on the given stream, and return
// cudaGetLastError(); Python binds them with ctypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// dtype codes, mirrored by _build.DTYPE_CODE
enum { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

// flash_attention.py NEG_INF: large negative instead of -inf, so that
// exp(m_prev - m_new) stays finite for fully masked tiles
#define FLASH_NEG_INF (-0.7f * 3.4028234663852886e38f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// max / sum over `width` consecutive lanes (width a power of two <= 32)
__device__ __forceinline__ float group_max(float v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Tensor-core product D += A(16x16 bf16, row) * B(16x8 bf16, col) with f32
// accumulators: a[4], b[2] hold bf16 pairs in the m16n8k16 fragment layout
// (lane = 4 * g + t: a rows g / g + 8, columns 2t, 2t + 1 / + 8; b columns
// g, rows 2t, 2t + 1 / + 8; c rows g / g + 8, columns 2t, 2t + 1).
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's cp.async groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// two 8x8 matrices, transposed: lanes 0-15 give the rows' addresses
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// 2^x in one MUFU instruction (exp2f adds a range reduction); meant for
// x <= 0: a result below 2^-126 flushes to 0, and 2^-inf is 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rows [r0, r0 + ROWS) of a row-strided (?, W) bf16 matrix into dst
// (leading dimension LDS), 16 bytes a cp.async: thread i copies chunk
// i % (W / 8) of rows i / (W / 8), i / (W / 8) + kThreads / (W / 8), ...;
// rows at or past `valid` are zero-filled without a read. Where W / 8
// chunks do not divide the threads (W 80 and 96 over 128 threads), the
// block's threads walk the tile's chunks in order instead, kThreads at a
// time.
template <int ROWS, int kThreads, int W = 64, int LDS = W + 8>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long st, int r0, int valid) {
  constexpr int kChunks = W / 8;
  if constexpr (kThreads % kChunks == 0) {
    constexpr int kStep = kThreads / kChunks;
    static_assert(ROWS % kStep == 0, "whole rows a pass");
    const int r = threadIdx.x / kChunks, c = (threadIdx.x % kChunks) * 8;
    dst += r * LDS + c;
    src += (r0 + r) * st + c;
#pragma unroll 4
    for (int rr = r0 + r; rr < r0 + ROWS; rr += kStep) {
      if (rr < valid)
        cp_async16(dst, src);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      dst += kStep * LDS;
      src += kStep * st;
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      if (r0 + r < valid)
        cp_async16(dst + r * LDS + c, src + (r0 + r) * st + c);
      else
        *reinterpret_cast<uint4*>(dst + r * LDS + c) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr float kLog2e = 1.4426950408889634f;

// (batch, row, head) element strides of a (B, S, H, d) operand
struct Strides {
  long long sb, st, sh;
};

// ---- 64-row tiles for the mma.sync backward kernels (K5, K6), whose blocks
// are kTileThreads threads: a warp owns 16 rows; fragments follow
// mma_16816's layout (g = lane / 4, tq = lane % 4).
constexpr int kTileThreads = 128;

// rows [r0, r0 + 64) x columns [c0, c0 + W) of a row-strided bf16 matrix
// into dst (leading dimension ld), 16 bytes a thread; zero past S rows or
// past `cols` columns. The compile-time stride lets the loop unroll, so a
// thread's loads are all in flight before its stores.
template <int W>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld, const __nv_bfloat16* base,
                                          long long st, int r0, int S, int c0, int cols) {
#pragma unroll
  for (int idx = threadIdx.x; idx < 64 * (W / 8); idx += kTileThreads) {
    const int rr = idx / (W / 8), cc = (idx % (W / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + rr * ld + cc) =
        (r0 + rr < S && c0 + cc < cols)
            ? *reinterpret_cast<const uint4*>(base + (r0 + rr) * st + c0 + cc)
            : make_uint4(0u, 0u, 0u, 0u);
  }
}

// A fragments (KS k-steps of 16) of the 16 tile rows from r0
template <int KS>
__device__ __forceinline__ void a_frags(uint32_t (&a)[KS][4], const __nv_bfloat16* t, int ld,
                                        int r0, int g, int tq) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[ks][e] = ld32(t + (r0 + g + 8 * (e & 1)) * ld + ks * 16 + 2 * tq + 8 * (e >> 1));
}

// c (16 x 64) += A (16 x 16 * ksteps, fragments) * B^T, B a 64-row tile
// stored [n][k]
__device__ __forceinline__ void mma_abt(float (&c)[8][4], const uint32_t (&a)[4][4],
                                        const __nv_bfloat16* bt, int ld, int ksteps, int g,
                                        int tq) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (ks >= ksteps) break;
#pragma unroll
    for (int nf = 0; nf < 8; ++nf) {
      const __nv_bfloat16* p = bt + (nf * 8 + g) * ld + ks * 16 + 2 * tq;
      const uint32_t b[2] = {ld32(p), ld32(p + 8)};
      mma_16816(c[nf], a[ks], b);
    }
  }
}

// c (16 x 8 * NF) += A (16 x 64, fragments over k = tile rows) * B, B a
// 64-row tile stored [k][n]
template <int NF>
__device__ __forceinline__ void mma_ab(float (&c)[NF][4], const uint32_t (&a)[4][4],
                                       const __nv_bfloat16* b, int ld, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int nj = 0; nj < NF / 2; ++nj) {
      uint32_t bfr[4];
      ldmatrix_x4_trans(bfr, b + (kk * 16 + (lane & 15)) * ld + nj * 16 + (lane >> 4) * 8);
      mma_16816(c[2 * nj], a[kk], bfr);
      mma_16816(c[2 * nj + 1], a[kk], bfr + 2);
    }
}

template <int NF>
__device__ __forceinline__ void zero(float (&c)[NF][4]) {
#pragma unroll
  for (int i = 0; i < NF; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
}

// accumulator pair (e, e + 1) of n-fragment nf -> its slot of an A fragment
// over the same 64 columns
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], int nf, int half, float lo, float hi) {
  a[nf >> 1][(nf & 1) * 2 + half] = pack_bf16x2(lo, hi);
}

// Attention-dropout keep test: the murmur-finalizer counter hash of
// flash_attention.dropout_keep_positions (JAX ops/flash_attention.py:120),
// 2 rounds, over (seed, b * H + h, absolute query position, key position).
// uint32 arithmetic wraps; keep when the hash is below thr (unsigned).
struct DropoutParams {
  uint32_t seed0, seed1, thr;
  float inv_keep;  // 1 / (1 - p)
  int on;
};

__device__ __forceinline__ bool dropout_keep(const DropoutParams& dp, uint32_t bh,
                                             uint32_t q_pos, uint32_t k_pos) {
  uint32_t x = dp.seed0 ^ (q_pos * 0x9E3779B9u) ^ (k_pos * 0x85EBCA77u) ^ (bh * 0xC2B2AE3Du);
  x += dp.seed1;
  // the two rounds (x ^= x >> 16, x *= 0x85EBCA6B, x ^= x >> 13,
  // x *= 0xC2B2AE35, x ^= x >> 16), with the first round's closing
  // x ^= x >> 16 and the second's opening one cancelled (shifts distribute
  // over xor and x >> 32 is 0) and the two multiplies between them folded
  // (0xC2B2AE35 * 0x85EBCA6B = 0xD1CBA227 mod 2^32): the same bits, 11
  // integer operations instead of 16
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xD1CBA227u;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x < dp.thr;
}

inline DropoutParams make_dropout(long long seed0, long long seed1, long long thr, float inv_keep,
                                  long long on) {
  DropoutParams d;
  d.seed0 = static_cast<uint32_t>(seed0);
  d.seed1 = static_cast<uint32_t>(seed1);
  d.thr = static_cast<uint32_t>(thr);
  d.inv_keep = inv_keep;
  d.on = static_cast<int>(on);
  return d;
}

// The additive score bias of K3 and K5 (JAX ops/flash_attention.py
// :350-370, :1009-1036), a template flag of their instances: f32 (B|1,
// H|1, Sq, Sk) at element strides sb, sh, sq (0 for a broadcast dim) and
// unit key stride; grad: K5's dbias, f32 (B, H, Sq, Sk) contiguous and
// zeroed by the wrapper, or NULL when the bias needs no gradient. The C
// entries take it as one host pointer to {p, sb, sh, sq, grad} (NULL: no
// bias), so a call without a bias passes one NULL more.
struct ScoreBias {
  const float* p = nullptr;
  long long sb = 0, sh = 0, sq = 0;
  float* grad = nullptr;
};

inline ScoreBias read_bias(const long long* desc) {
  ScoreBias s;
  if (desc) {
    s.p = reinterpret_cast<const float*>(static_cast<uintptr_t>(desc[0]));
    s.sb = desc[1];
    s.sh = desc[2];
    s.sq = desc[3];
    s.grad = reinterpret_cast<float*>(static_cast<uintptr_t>(desc[4]));
  }
  return s;
}

// Four consecutive elements as f32 (4-element aligned pointers): one 16-,
// 8- or 4-byte load.
struct Vec4 {
  float x, y, z, w;
};

__device__ __forceinline__ Vec4 load4(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return {v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ Vec4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return {a.x, a.y, b.x, b.y};
}

__device__ __forceinline__ Vec4 load4(const int8_t* p) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  return {static_cast<float>(v.x), static_cast<float>(v.y), static_cast<float>(v.z),
          static_cast<float>(v.w)};
}

// cluster-wide barrier: release before, acquire after, so that each CTA's
// writes (to device or shared memory) are visible to the cluster's other CTAs
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Block-wide reductions; every thread gets the result. `red` holds >= 32
// floats of shared memory and may be reused right after the call.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : -INFINITY;
  v = warp_max(v);
  __syncthreads();
  return v;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
  v = warp_sum(v);
  __syncthreads();
  return v;
}

// the dynamic shared memory of kernel Kern, set once per device (the
// attribute is per device; setting it on every launch costs host time)
template <auto Kern>
cudaError_t allow_smem(size_t smem) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// The SIMT loops' head-dim-wide tiles are static arrays where all of a
// kernel's tiles fit the 48 KB of static shared memory (head dim 64), and
// rows of dynamic shared memory past it, handed out in turn by DynRows
// (the launcher passes their bytes and raises the kernel's limit through
// allow_smem).
constexpr int kStaticSmemBytes = 48 * 1024;

struct DynRows {
  float* p;
  __device__ __forceinline__ DynRows() {
    extern __shared__ __align__(16) float simt_dyn[];
    p = simt_dyn;
  }
  // the next rows x COLS floats
  template <int COLS>
  __device__ __forceinline__ float (*take(int rows))[COLS] {
    float(*t)[COLS] = reinterpret_cast<float(*)[COLS]>(p);
    p += rows * COLS;
    return t;
  }
};

// The head dims the attention kernels (K3, K5, K9) are built for, the
// one list of them (ops/flash_attention.py HEAD_DIMS mirrors it;
// tests/test_torch_head_dims.py holds the two equal): f(D) for d's
// instance, D a std::integral_constant<int, d>; any other d is refused.
template <class F>
auto with_head_dim(long long d, F&& f) {
  using R = decltype(f(std::integral_constant<int, 64>{}));
  switch (d) {
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 128: return f(std::integral_constant<int, 128>{});
  }
  return static_cast<R>(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
