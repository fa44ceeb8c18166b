// K7: MLP forward, out = act(x @ W1 + b1) @ W2 + b2, which also writes
// h_pre = x @ W1 + b1 (rounded to the working dtype) for the backward.
//
// Replaces the TPU kernel backpacks_flash_attn_tpu/ops/fused_mlp.py
// mlp_fwd_fused (:81, Pallas body _mlp_fwd_kernel :51). As there, the
// activation is applied to the ROUNDED pre-activation (what the backward of
// ops/dense.py recomputes from), both products accumulate in f32, and out
// is rounded once after its bias.
//
// Bound on the H100 at the training shape (16384 tokens, 768 -> 3072 ->
// 768, bf16): the operations, 155 GFLOP = 0.156 ms at 989 TFLOP/s, against
// ~150 MB of x, h_pre and out (0.045 ms). The TPU kernel fuses both
// products around a (1024, d_out) f32 accumulator in VMEM. On the H100 even
// a 128-token x 768 f32 out tile (384 KB) exceeds an SM's registers and
// shared memory, so full fusion forces small token tiles, each of which
// re-reads all of W1 and W2 (9.4 MB at gpt3-small) from L2. The fusion only
// saves the activation's trip through device memory (100.7 MB each way at
// the training shape, ~0.03 ms at 3.35 TB/s). So K7 runs as two GEMM
// passes split at h_pre, launched by one C entry point:
//   pass 1 (fc1): h_pre = x @ W1 + b1; the epilogue adds b1 in f32, rounds,
//     stores h_pre, applies the activation in f32 to the rounded value and
//     stores it, rounded, into a transient (T, inner) buffer the wrapper
//     allocates for the call (the activation is computed once an element);
//   pass 2 (fc2): out = act @ W2 + b2, b2 added in f32, out rounded once.
// Both passes run one GEMM template with the epilogue as its argument.
// bf16, on the tensor cores: a 128 x BN output tile a block (BN = 256
// where it divides N, else 128), two consumer warpgroups of 64 rows each
// issuing wgmma m64nBNk16 (bf16 operands from shared memory, f32
// accumulators in registers), one producer thread keeping TMA loads of
// 64-deep K slices in flight on a 4-stage mbarrier ring (128-byte swizzle;
// the (in, out) weights are read N-major through wgmma's transpose bit, so
// no transposed copy is made). The tile leaves through shared memory in
// 16-byte row chunks, the activation applied chunk by chunk. f32: 128 x 128
// tiles of 256 threads, 8 x 8 outputs a thread, K in steps of 8 through
// double-buffered shared memory, every product in f32 (no TF32).
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case 0:  // gelu (erf)
      return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
    case 1:  // gelu_new / gelu_fast (tanh)
      return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
    case 2:  // relu
      return fmaxf(x, 0.f);
    default: {  // sqrelu
      const float r = fmaxf(x, 0.f);
      return r * r;
    }
  }
}

// The epilogue of one pass over an (M, N) output. FC1: out0 = h_pre,
// out1 = act(h_pre); otherwise out0 = out and out1 is unused.
template <typename T>
struct Epi {
  const T* bias;
  T* out0;
  T* out1;
  int M, N, act;
};

// columns (col, col + 1) of row `row`: bias, store (and for FC1 the
// activation beside it)
template <bool FC1>
__device__ __forceinline__ void store_pair(const Epi<float>& e, int row, int col, float v0,
                                           float v1) {
  if (row >= e.M) return;
  const float2 b = *reinterpret_cast<const float2*>(e.bias + col);
  const float2 h = make_float2(v0 + b.x, v1 + b.y);
  const long long off = static_cast<long long>(row) * e.N + col;
  *reinterpret_cast<float2*>(e.out0 + off) = h;
  if (FC1)
    *reinterpret_cast<float2*>(e.out1 + off) =
        make_float2(activate(h.x, e.act), activate(h.y, e.act));
}

// Output tiles of a 1-D grid, the N tiles of one row tile adjacent so that
// they share its A rows in L2.
__device__ __forceinline__ void tile_origin(int n_tiles, int bm, int bn, int& m0, int& n0) {
  m0 = static_cast<int>(blockIdx.x / n_tiles) * bm;
  n0 = static_cast<int>(blockIdx.x % n_tiles) * bn;
}

// ------------------------------------------------------------- bf16 (wgmma + TMA)

constexpr int WBM = 128, WBK = 64, kWStages = 4, kConsumers = 2;
constexpr int kWThreads = 128 * (kConsumers + 1);  // two consumer warpgroups, one producer

// The ring of a 128 x BN tile: a stage holds the A tile (WBM rows of 128
// bytes) and BN / 64 B boxes (WBK rows of 64 columns, 128 bytes), each in
// TMA's 128-byte swizzle; one block an SM.
template <int BN>
struct WTile {
  static constexpr uint32_t kA = WBM * WBK * 2, kBox = WBK * 128, kStage = kA + BN / 64 * kBox;
  static constexpr size_t kSmem = kWStages * kStage + 1024 + 2 * kWStages * 8;
  // the epilogue stages the warpgroups' tiles in the ring's memory
  static_assert(kConsumers * 64 * (BN + 8) * 2 <= kWStages * kStage, "staging");
};

// d (64 x N, f32, the warpgroup's accumulator fragments) = A (64 x 16,
// K-major) * B (16 x N, N-major: the transpose bit set), plus d if acc
template <int N>
__device__ void wgmma_bf16(float* d, uint64_t da, uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(acc));
}

// The epilogue of a warpgroup's 64 x BN accumulator tile at (m0, n0): bias
// in f32 and rounding into shared memory (`staged`, 64 rows of BN + 8),
// then whole rows out in 16-byte chunks, rows past M skipped; for FC1 each
// chunk's activation (of the rounded values, in f32) is stored beside it.
// The activation runs in a rolled loop over chunks: unrolled over the
// accumulators its code outgrows the instruction cache. Fragment layout:
// warp w holds rows 16 w + lane / 4 (+ 8), n8 chunk j columns
// 8 j + 2 (lane % 4) (+ 1), in acc[4 j ..].
template <int BN, bool FC1>
__device__ __forceinline__ void epilogue_staged(const float (&acc)[BN / 2], const Epi<bf16>& e,
                                                bf16* staged, int m0, int n0, int wg) {
  constexpr int LD = BN + 8;  // 16-byte row shift: the fragment writes are conflict-free
  const int lane = threadIdx.x & 31, r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(e.bias + n0 + c));
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<__nv_bfloat162*>(staged + (r0 + 8 * half) * LD + c) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half] + b.x, acc[4 * j + 2 * half + 1] + b.y);
  }
  bar_sync(2 + wg, 128);
#pragma unroll 1
  for (int i = threadIdx.x & 127; i < 64 * BN / 8; i += 128) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    if (m0 + r >= e.M) break;  // i grows with r
    const long long off = static_cast<long long>(m0 + r) * e.N + n0 + c;
    const uint4 h = *reinterpret_cast<const uint4*>(staged + r * LD + c);
    *reinterpret_cast<uint4*>(e.out0 + off) = h;
    if (FC1) {
      uint4 a;
      const __nv_bfloat162* hp = reinterpret_cast<const __nv_bfloat162*>(&h);
      __nv_bfloat162* ap = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        ap[q] = __floats2bfloat162_rn(activate(__low2float(hp[q]), e.act),
                                      activate(__high2float(hp[q]), e.act));
      *reinterpret_cast<uint4*>(e.out1 + off) = a;
    }
  }
}

// C (M, N) = A (M, K) @ B (K, N) through the epilogue; A and B row-major
// bf16 behind TMA maps (A in 64 x 128 boxes, B in 64 x 64), K a multiple of
// WBK, N of BN. A 128 x BN tile a block: warpgroups 0 and 1 take 64 rows
// each on wgmma, warpgroup 2's first thread keeps kWStages TMA loads in
// flight on a full/empty mbarrier ring. Rows past M load as zeros and are
// not stored.
template <int BN, bool FC1>
__global__ void __launch_bounds__(kWThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, Epi<bf16> e, int K) {
  using Tile = WTile<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle's 1024-byte atoms
  const uint32_t full = base + kWStages * Tile::kStage, empty = full + 8 * kWStages;
  int m0, n0;
  tile_origin(e.N / BN, WBM, BN, m0, n0);
  const int n_k = K / WBK, wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kWStages;
        if (kt >= kWStages) mbar_wait(empty + 8 * s, (kt / kWStages - 1) & 1);
        const uint32_t st = base + s * Tile::kStage, bar = full + 8 * s;
        mbar_expect_tx(bar, Tile::kStage);
        tma_load_2d(st, &map_a, bar, kt * WBK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(st + Tile::kA + j * Tile::kBox, &map_b, bar, n0 + 64 * j, kt * WBK);
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // no instruction but wgmma defines the accumulators until the last
    // wait (else ptxas serializes the products): the first product
    // overwrites them
    float acc[BN / 2];
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % kWStages;
      mbar_wait(full + 8 * s, (kt / kWStages) & 1);
      const uint32_t sa = base + s * Tile::kStage + wg * 64 * 128, sb = sa - wg * 64 * 128 + Tile::kA;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      // k16 steps: A's start moves 32 bytes inside its swizzle atom, B's by
      // 16 rows; B's 64-column boxes lie Tile::kBox apart (leading offset),
      // 8-row groups 1024 bytes apart (stride offset) in both
#pragma unroll
      for (int kk = 0; kk < WBK / 16; ++kk)
        wgmma_bf16<BN>(acc, smem_desc(sa + 32 * kk, 16, 1024),
                       smem_desc(sb + 16 * 128 * kk, Tile::kBox, 1024), kt > 0 || kk > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // k-tile kt - 1 is done
      if (kt > 0 && (threadIdx.x & 127) == 0) mbar_arrive(empty + 8 * ((kt - 1) % kWStages));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    bar_sync(1, 128 * kConsumers);  // both warpgroups are done with the ring
    bf16* staged = reinterpret_cast<bf16*>(smem_raw + (base - smem_u32(smem_raw))) +
                   wg * 64 * (BN + 8);
    epilogue_staged<BN, FC1>(acc, e, staged, m0 + wg * 64, n0, wg);
  }
}

// ------------------------------------------------------------- f32 (SIMT)

constexpr int FBM = 128, FBN = 128, FBK = 8, kFThreads = 256;
constexpr int LDF = FBM + 4;  // 132-float rows: the transposed A store is conflict-free

// C (M, N) = A (M, K) @ B (K, N) through the epilogue, every product in
// f32. Thread (ty, tx) of 16 x 16 owns rows 4 ty + {0..3} and 64 + 4 ty +
// {0..3}, columns 4 tx + {0..3} and 64 + 4 tx + {0..3}. K a multiple of
// FBK, N of FBN.
template <bool FC1>
__global__ void __launch_bounds__(kFThreads, 2)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B, Epi<float> e, int K) {
  __shared__ __align__(16) float As[2][FBK][LDF];  // A tile transposed: [k][m]
  __shared__ __align__(16) float Bs[2][FBK][FBN];
  int m0, n0;
  tile_origin(e.N / FBN, FBM, FBN, m0, n0);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // one float4 of A (row tid / 2, k 4 (tid % 2)) and of B (row tid / 32,
  // columns 4 (tid % 32)) a thread per k-step; rows past M read row M - 1
  const int a_r = tid >> 1, a_c = (tid & 1) * 4, b_r = tid >> 5, b_c = (tid & 31) * 4;
  const float* a_ptr = A + static_cast<long long>(min(m0 + a_r, e.M - 1)) * K + a_c;
  const float* b_ptr = B + static_cast<long long>(b_r) * e.N + n0 + b_c;
  const long long b_step = static_cast<long long>(FBK) * e.N;

  float4 ra = *reinterpret_cast<const float4*>(a_ptr);
  float4 rb = *reinterpret_cast<const float4*>(b_ptr);
  auto stash = [&](int buf) {
    As[buf][a_c + 0][a_r] = ra.x;
    As[buf][a_c + 1][a_r] = ra.y;
    As[buf][a_c + 2][a_r] = ra.z;
    As[buf][a_c + 3][a_r] = ra.w;
    *reinterpret_cast<float4*>(&Bs[buf][b_r][b_c]) = rb;
  };
  stash(0);
  __syncthreads();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int n_k = K / FBK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_k) {  // the next k-step's loads in flight during this one
      ra = *reinterpret_cast<const float4*>(a_ptr + (kt + 1) * FBK);
      rb = *reinterpret_cast<const float4*>(b_ptr + (kt + 1) * b_step);
    }
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][k][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < n_k) stash(cur ^ 1);  // the other buffer was consumed before the last barrier
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i >> 2) * 64 + 4 * ty + (i & 3);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const int col = n0 + (j >> 2) * 64 + 4 * tx + (j & 3);
      store_pair<FC1>(e, row, col, acc[i][j], acc[i][j + 1]);
    }
  }
}

template <bool FC1>
cudaError_t gemm_f32(const float* A, const float* B, const Epi<float>& e, int K, cudaStream_t st) {
  const unsigned blocks = ((e.M + FBM - 1) / FBM) * (e.N / FBN);
  gemm_f32_kernel<FC1><<<blocks, kFThreads, 0, st>>>(A, B, e, K);
  return cudaGetLastError();
}

// a row-major (rows, cols) bf16 matrix in boxes of box_rows x 64 columns
// (128 bytes), 128-byte swizzle; reads past the last row give zeros
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(bf16)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)}, step[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN, bool FC1>
cudaError_t gemm_wgmma(const bf16* A, const bf16* B, const Epi<bf16>& e, int K, cudaStream_t st) {
  CUtensorMap ma, mb;
  cudaError_t err = tensor_map(&ma, A, e.M, K, WBM);
  if (err == cudaSuccess) err = tensor_map(&mb, B, K, e.N, WBK);
  if (err == cudaSuccess) err = allow_smem<gemm_wgmma_kernel<BN, FC1>>(WTile<BN>::kSmem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = ((e.M + WBM - 1) / WBM) * (e.N / BN);
  gemm_wgmma_kernel<BN, FC1><<<blocks, kWThreads, WTile<BN>::kSmem, st>>>(ma, mb, e, K);
  return cudaGetLastError();
}

// 128 x 256 tiles where 256 divides N, else 128 x 128
template <bool FC1>
cudaError_t gemm_bf16_tc(const bf16* A, const bf16* B, const Epi<bf16>& e, int K, cudaStream_t st) {
  return e.N % 256 == 0 ? gemm_wgmma<256, FC1>(A, B, e, K, st) : gemm_wgmma<128, FC1>(A, B, e, K, st);
}

template <typename T, typename Gemm1, typename Gemm2>
int two_passes(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               void* out, void* hpre, void* act_buf, int T_, int d_in, int inner, int d_out,
               int act, Gemm1 fc1, Gemm2 fc2, cudaStream_t st) {
  const Epi<T> e1{static_cast<const T*>(b1), static_cast<T*>(hpre), static_cast<T*>(act_buf),
                  T_, inner, act};
  const Epi<T> e2{static_cast<const T*>(b2), static_cast<T*>(out), nullptr, T_, d_out, act};
  cudaError_t err = fc1(static_cast<const T*>(x), static_cast<const T*>(w1), e1, d_in, st);
  if (err == cudaSuccess)
    err = fc2(static_cast<const T*>(act_buf), static_cast<const T*>(w2), e2, inner, st);
  return static_cast<int>(err);
}

}  // namespace

// x (T, d_in), w1 (d_in, inner), b1 (inner,), w2 (inner, d_out), b2 (d_out,)
// -> out (T, d_out), hpre (T, inner), through act_buf (T, inner), the
// activated pre-activation that pass 2 reads; all contiguous, one dtype
// (bf16 or f32); every dim a multiple of 128
extern "C" int fused_mlp_fwd_launch(const void* x, const void* w1, const void* b1, const void* w2,
                                    const void* b2, void* out, void* hpre, void* act_buf,
                                    long long T, long long d_in, long long inner, long long d_out,
                                    long long act, long long dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d_in % 128 || inner % 128 || d_out % 128 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int t = static_cast<int>(T), k1 = static_cast<int>(d_in), n1 = static_cast<int>(inner),
            n2 = static_cast<int>(d_out), a = static_cast<int>(act);
  if (dtype == DT_BF16)
    return two_passes<bf16>(x, w1, b1, w2, b2, out, hpre, act_buf, t, k1, n1, n2, a,
                            gemm_bf16_tc<true>, gemm_bf16_tc<false>, st);
  if (dtype == DT_F32)
    return two_passes<float>(x, w1, b1, w2, b2, out, hpre, act_buf, t, k1, n1, n2, a,
                             gemm_f32<true>, gemm_f32<false>, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
