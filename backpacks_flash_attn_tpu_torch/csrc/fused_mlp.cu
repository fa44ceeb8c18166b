// K7: fused MLP forward, out = act(x @ W1 + b1) @ W2 + b2, which also
// writes h_pre = x @ W1 + b1 (rounded to the working dtype) for the
// backward; the activation never reaches device memory.
//
// Replaces the TPU kernel backpacks_flash_attn_tpu/ops/fused_mlp.py
// mlp_fwd_fused (:81, Pallas body _mlp_fwd_kernel :51). As there, the
// activation is applied to the ROUNDED pre-activation (what the backward of
// ops/dense.py recomputes from), and both products accumulate in f32.
//
// Bound on the H100 at the training shape (16384 tokens, 768 -> 3072 ->
// 768, bf16): the operations, 155 GFLOP = 0.156 ms at 989 TFLOP/s, against
// ~150 MB of x, h_pre and out (0.045 ms). The TPU kernel keeps a
// (1024, d_out) f32 accumulator in VMEM; here a 64-row tile of it would
// already take 196 KB of the 227 KB of shared memory. Design: the out
// accumulator of a 32-token tile lives in registers, split over the 8 warps
// of a 256-thread block (2 row groups of 16 x 4 column groups of d_out / 4:
// 96 f32 a thread at d_out 768). The block keeps its x tile in shared
// memory and walks the inner dimension in 32-column chunks: fc1 for the
// chunk (32 x 32 over d_in, one 16 x 8 fragment a warp) with bias, the
// h_pre store and the activation fused, the activated chunk to shared
// memory as bf16, then fc2's rank-32 update of the out tile. Products on
// mma.sync m16n8k16 (bf16 in, f32 accumulators). The W1 chunk of the next
// step loads (cp.async) while fc2 runs and the W2 chunk while fc1 runs. The
// weights are re-read from L2 by every token tile (9.4 MB a tile at
// gpt3-small): that traffic, and one block per SM, are what bound this
// first version. Past d_in 1024 the x tile no longer fits beside the W1
// chunk, so fc1 streams x and W1 together in 128-row pieces of d_in (the
// same products in the same order; x is then re-read from L2 once a
// chunk). Outputs wider than 768 are split into column slabs (grid y) that
// each recompute fc1; slab 0 writes h_pre. f32 operands take a SIMT
// version (16-token tiles, 16-column chunks, x and W1 streamed in 128-row
// pieces of d_in, every product in f32).
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int BT = 32, BI = 32, kThreads = 256;
constexpr int LDW1 = BI + 8, LDA = BI + 8;  // 80-byte smem rows
constexpr int KC = 128;         // rows of d_in a streamed fc1 piece covers
constexpr int XRES_MAX = 1024;  // widest d_in whose x tile stays in smem

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

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// rows x cols (cols a multiple of 8) of a row-major bf16 matrix into shared
// memory with leading dimension ld, 16 bytes a cp.async
__device__ __forceinline__ void load_async(bf16* dst, int ld, const bf16* src, long long ld_src,
                                           int rows, int cols) {
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * 8;
    cp_async16(dst + r * ld + c, src + r * ld_src + c);
  }
}

// columns [k0, k0 + cols) of the BT-token x tile from row t0 into shared
// memory with leading dimension ldx; rows past T are zero
__device__ __forceinline__ void load_x_async(bf16* Xs, int ldx, const bf16* x, int t0, int T,
                                             int d_in, int k0, int cols) {
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < BT * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * 8;
    if (t0 + r < T)
      cp_async16(Xs + r * ldx + c, x + static_cast<long long>(t0 + r) * d_in + k0 + c);
    else
      *reinterpret_cast<uint4*>(Xs + r * ldx + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// fc1 over k_len rows of d_in (a multiple of 64): this warp's 16 x 8 of the
// 32 x 32 pre-activation chunk, in four independent accumulator chains over
// k (chain j takes the 16-row steps ks = j mod 4) so that the tensor-core
// latency overlaps
__device__ __forceinline__ void fc1_mma(float (&hp)[4][4], const bf16* Xs, int ldx,
                                        const bf16* W1s, int k_len, int rg, int cg) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const bf16* xa = Xs + (16 * rg + g) * ldx + 2 * tq;
  for (int k0 = 0; k0 < k_len / 16; k0 += 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ks = k0 + j;
      const uint32_t a[4] = {ld32(xa + ks * 16), ld32(xa + 8 * ldx + ks * 16),
                             ld32(xa + ks * 16 + 8), ld32(xa + 8 * ldx + ks * 16 + 8)};
      uint32_t bfr[2];
      ldmatrix_x2_trans(bfr, W1s + (ks * 16 + (lane & 15)) * LDW1 + cg * 8);
      mma_16816(hp[j], a, bfr);
    }
  }
}

// NF: n-fragments of 8 columns a warp owns in fc2; the block's slab of out
// columns is 4 * 8 * NF wide. XRES: the x tile stays in shared memory and
// the whole W1 chunk is prefetched during fc2; otherwise fc1 streams x and
// W1 in KC-row pieces of d_in.
template <int NF, bool XRES>
__global__ void __launch_bounds__(kThreads, 1)
mlp_fwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                    const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                    const bf16* __restrict__ b2, bf16* __restrict__ out,
                    bf16* __restrict__ hpre, int T, int d_in, int inner, int d_out, int act) {
  constexpr int SLAB = 32 * NF, LDW2 = SLAB + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k_rows = XRES ? d_in : KC, ldx = k_rows + 8;
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);  // BT x ldx
  bf16* W1s = Xs + BT * ldx;                     // k_rows x LDW1 ([k][n])
  bf16* W2s = W1s + k_rows * LDW1;               // BI x LDW2 ([k][n])
  bf16* As = W2s + BI * LDW2;                    // BT x LDA, activated chunk

  const int t0 = blockIdx.x * BT, n0 = blockIdx.y * SLAB;
  const bool write_h = blockIdx.y == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
  const int rg = warp & 1, cg = warp >> 1;  // 16-row group, column group

  // (resident) x tile and W1 chunk 0, then W2 chunk 0
  if (XRES) {
    load_x_async(Xs, ldx, x, t0, T, d_in, 0, d_in);
    load_async(W1s, LDW1, w1, inner, d_in, BI);
  }
  cp_async_commit();
  load_async(W2s, LDW2, w2 + n0, d_out, BI, SLAB);
  cp_async_commit();

  float acc[NF][4];
  zero(acc);
  const int n_chunks = inner / BI;
  for (int c = 0; c < n_chunks; ++c) {
    float hp[4][4];
    zero(hp);
    if (XRES) {
      cp_async_wait<1>();  // x and W1 chunk c have landed
      __syncthreads();
      fc1_mma(hp, Xs, ldx, W1s, d_in, rg, cg);
    } else {
      for (int k0 = 0; k0 < d_in; k0 += KC) {
        __syncthreads();  // the previous piece is consumed
        load_x_async(Xs, ldx, x, t0, T, d_in, k0, KC);
        load_async(W1s, LDW1, w1 + static_cast<long long>(k0) * inner + c * BI, inner, KC, BI);
        cp_async_commit();
        cp_async_wait<0>();  // this piece (and W2 chunk c) have landed
        __syncthreads();
        fc1_mma(hp, Xs, ldx, W1s, KC, rg, cg);
      }
    }
    float hc[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) hc[e] = (hp[0][e] + hp[1][e]) + (hp[2][e] + hp[3][e]);
    const int colc = cg * 8 + 2 * tq, col = c * BI + colc;
    const float bia = to_f32(b1[col]), bib = to_f32(b1[col + 1]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = 16 * rg + g + 8 * half, row = t0 + rl;
      const __nv_bfloat162 h = __floats2bfloat162_rn(hc[2 * half] + bia, hc[2 * half + 1] + bib);
      if (write_h && row < T)
        *reinterpret_cast<__nv_bfloat162*>(hpre + static_cast<long long>(row) * inner + col) = h;
      *reinterpret_cast<__nv_bfloat162*>(As + rl * LDA + colc) = __floats2bfloat162_rn(
          activate(__low2float(h), act), activate(__high2float(h), act));
    }
    __syncthreads();  // As complete; W1s free
    if (XRES && c + 1 < n_chunks) load_async(W1s, LDW1, w1 + (c + 1) * BI, inner, d_in, BI);
    cp_async_commit();
    cp_async_wait<1>();  // W2 chunk c has landed
    __syncthreads();
    // fc2: out tile (16 rows x 8 NF columns a warp) += act chunk @ W2 chunk
    uint32_t aa[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        aa[ks][e] = ld32(As + (16 * rg + g + 8 * (e & 1)) * LDA + ks * 16 + 2 * tq + 8 * (e >> 1));
    const bf16* wb = W2s + cg * 8 * NF;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int nj = 0; nj < NF / 2; ++nj) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, wb + (ks * 16 + (lane & 15)) * LDW2 + nj * 16 + (lane >> 4) * 8);
        mma_16816(acc[2 * nj], aa[ks], bfr);
        mma_16816(acc[2 * nj + 1], aa[ks], bfr + 2);
      }
    __syncthreads();  // W2s and As free
    if (c + 1 < n_chunks)
      load_async(W2s, LDW2, w2 + static_cast<long long>((c + 1) * BI) * d_out + n0, d_out, BI,
                 SLAB);
    cp_async_commit();
  }

#pragma unroll
  for (int nf = 0; nf < NF; ++nf) {
    const int col = n0 + cg * 8 * NF + nf * 8 + 2 * tq;
    const float ba = to_f32(b2[col]), bb = to_f32(b2[col + 1]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = t0 + 16 * rg + g + 8 * half;
      if (row < T)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row) * d_out + col) =
            __floats2bfloat162_rn(acc[nf][2 * half] + ba, acc[nf][2 * half + 1] + bb);
    }
  }
}

// ------------------------------------------------------------- f32 (SIMT)

constexpr int FT = 16, FI = 16;

// NJ: out columns a thread owns (c + 16 j); the slab is 16 * NJ wide.
// Thread (r, c) = token t0 + r, pre-activation column c of each chunk.
template <int NJ>
__global__ void __launch_bounds__(kThreads, 1)
mlp_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, float* __restrict__ out,
                   float* __restrict__ hpre, int T, int d_in, int inner, int d_out, int act) {
  constexpr int SLAB = 16 * NJ, LDX = KC + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Xs = reinterpret_cast<float*>(smem_raw);  // FT x LDX, a piece of x
  float* W1s = Xs + FT * LDX;                      // KC x FI
  float* W2s = W1s + KC * FI;                      // FI x SLAB
  float* As = W2s + FI * SLAB;                     // FT x (FI + 1)

  const int t0 = blockIdx.x * FT, n0 = blockIdx.y * SLAB;
  const bool write_h = blockIdx.y == 0;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < inner; c0 += FI) {
    float h = 0.f;
    for (int k0 = 0; k0 < d_in; k0 += KC) {
      __syncthreads();  // the previous piece (and chunk) is consumed
      for (int i = threadIdx.x; i < FT * KC / 4; i += kThreads) {
        const int rr = i / (KC / 4), cc = (i % (KC / 4)) * 4;
        *reinterpret_cast<float4*>(Xs + rr * LDX + cc) =
            t0 + rr < T ? *reinterpret_cast<const float4*>(
                              x + static_cast<long long>(t0 + rr) * d_in + k0 + cc)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int i = threadIdx.x; i < KC * FI / 4; i += kThreads) {
        const int k = i / (FI / 4), cc = (i % (FI / 4)) * 4;
        *reinterpret_cast<float4*>(W1s + k * FI + cc) = *reinterpret_cast<const float4*>(
            w1 + static_cast<long long>(k0 + k) * inner + c0 + cc);
      }
      if (k0 == 0)
        for (int i = threadIdx.x; i < FI * SLAB / 4; i += kThreads) {
          const int k = i / (SLAB / 4), cc = (i % (SLAB / 4)) * 4;
          *reinterpret_cast<float4*>(W2s + k * SLAB + cc) = *reinterpret_cast<const float4*>(
              w2 + static_cast<long long>(c0 + k) * d_out + n0 + cc);
        }
      __syncthreads();
      for (int k = 0; k < KC; ++k) h += Xs[r * LDX + k] * W1s[k * FI + c];
    }
    h += b1[c0 + c];
    if (write_h && t0 + r < T) hpre[static_cast<long long>(t0 + r) * inner + c0 + c] = h;
    As[r * (FI + 1) + c] = activate(h, act);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < FI; ++kk) {
      const float a = As[r * (FI + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j] += a * W2s[kk * SLAB + c + 16 * j];
    }
  }
  if (t0 + r >= T) return;
  float* orow = out + static_cast<long long>(t0 + r) * d_out + n0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) orow[c + 16 * j] = acc[j] + b2[n0 + c + 16 * j];
}

struct Args {
  const void *x, *w1, *b1, *w2, *b2;
  void *out, *hpre;
  int T, d_in, inner, d_out, act;
};

template <int SLAB, bool XRES>
int launch_bf16(const Args& a, cudaStream_t st) {
  constexpr int NF = SLAB / 32;
  const size_t k_rows = XRES ? a.d_in : KC;
  const size_t smem = sizeof(bf16) * (BT * (k_rows + 8) + k_rows * LDW1 +
                                      static_cast<size_t>(BI) * (SLAB + 8) + BT * LDA);
  auto kern = mlp_fwd_bf16_kernel<NF, XRES>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.T + BT - 1) / BT), static_cast<unsigned>(a.d_out / SLAB));
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.w1), static_cast<const bf16*>(a.b1),
      static_cast<const bf16*>(a.w2), static_cast<const bf16*>(a.b2), static_cast<bf16*>(a.out),
      static_cast<bf16*>(a.hpre), a.T, a.d_in, a.inner, a.d_out, a.act);
  return static_cast<int>(cudaGetLastError());
}

template <int SLAB>
int launch_f32(const Args& a, cudaStream_t st) {
  constexpr int NJ = SLAB / 16;
  const size_t smem = sizeof(float) * (static_cast<size_t>(FT) * (KC + 4) + KC * FI +
                                       static_cast<size_t>(FI) * SLAB + FT * (FI + 1));
  auto kern = mlp_fwd_f32_kernel<NJ>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.T + FT - 1) / FT), static_cast<unsigned>(a.d_out / SLAB));
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.w1),
      static_cast<const float*>(a.b1), static_cast<const float*>(a.w2),
      static_cast<const float*>(a.b2), static_cast<float*>(a.out), static_cast<float*>(a.hpre),
      a.T, a.d_in, a.inner, a.d_out, a.act);
  return static_cast<int>(cudaGetLastError());
}

template <int SLAB>
int launch(const Args& a, long long dtype, cudaStream_t st) {
  if (dtype == DT_BF16)
    return a.d_in <= XRES_MAX ? launch_bf16<SLAB, true>(a, st) : launch_bf16<SLAB, false>(a, st);
  if (dtype == DT_F32) return launch_f32<SLAB>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (T, d_in), w1 (d_in, inner), b1 (inner,), w2 (inner, d_out), b2 (d_out,)
// -> out (T, d_out), hpre (T, inner); all contiguous, one dtype (bf16 or
// f32); every dim a multiple of 128
extern "C" int fused_mlp_fwd_launch(const void* x, const void* w1, const void* b1, const void* w2,
                                    const void* b2, void* out, void* hpre, long long T,
                                    long long d_in, long long inner, long long d_out,
                                    long long act, long long dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d_in % 128 || inner % 128 || d_out % 128 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, w1, b1, w2, b2, out, hpre, static_cast<int>(T), static_cast<int>(d_in),
               static_cast<int>(inner), static_cast<int>(d_out), static_cast<int>(act)};
  // the widest slab that divides the output: one slab (no recomputed fc1)
  // up to d_out 768
  if (d_out % 768 == 0) return launch<768>(a, dtype, st);
  if (d_out % 512 == 0) return launch<512>(a, dtype, st);
  if (d_out % 384 == 0) return launch<384>(a, dtype, st);
  if (d_out % 256 == 0) return launch<256>(a, dtype, st);
  return launch<128>(a, dtype, st);
}
