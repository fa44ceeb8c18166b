// Shared helpers of the port's CUDA kernels (sm_90a, built by ops/_build.py).
//
// Every kernel file exposes plain C entry points that take device pointers,
// sizes and strides as integers, launch on the given stream, and return
// cudaGetLastError(); Python binds them with ctypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
