// K1-gathered: K1's length-adaptive redesign, on K1's body.
//
// Replaces the TPU kernel backpacks_flash_attn_tpu/ops/decode_attention.py
// decode_attention_gathered (:238, Pallas body _gathered_kernel :184). It
// computes K1's function (decode_attention.cu):
//   out[e] = softmax_{s < len[e]}((q[e] . kt[e,:,s]) * ks[e,s]) * vs[e,s] @ v[e,s,:]
// and, as the Pallas body, 0 for a row of length <= 0. q pre-scaled (E, dk);
// kt (E, dk, S); v (E, S, dv); optional f32 ks/vs (E, S); a scalar or per-row
// length; out (E, dv) in q's dtype. bf16 q over int8 or bf16 caches, f32 q
// over int8 or f32; any outer strides (window slices), unit inner stride. All
// arithmetic is f32. JAX's block_s and rows_per_program tile the TPU's walk;
// here they choose nothing.
//
// Bound on the H100: memory, as K1 (~2 flops a byte read): each valid
// position's key and value rows once, plus its scales.
//
// The TPU kernel walks each row's valid blocks in order, so its HBM traffic
// follows each row's actual length. On the card the question is how that
// work lands on the SMs. ops/decode_attention.py _gathered_schedule picks one
// of two launches:
//   Many rows (K1's schedule needs no split): K1's own launch
// (decode_attention_launch, decode_attention.cu) with its (m, l) outputs,
// whose empty row is 0; counted as decode_attention_gathered.
//   Few rows: this file's kernel. K1 gives every row the same number of CTAs
// (a cluster), which leaves the SMs unequal work: 192 CTAs on 132 SMs at
// gpt-generate's 96 rows, and with ragged lengths an SM holding two long
// rows' CTAs reads ~1.8x the mean. Here the grid is the CTAs the card holds
// at once (G = SMs x CTAs an SM, each one row group of K1's shape), and the
// rows' valid group tiles, laid end to end (T of them), are split evenly:
// CTA c takes tiles [c T / G', (c + 1) T / G'), G' = min(G, T), so that no
// CTA's work exceeds another's by more than one tile. Every CTA reads the E
// lengths and takes their prefix sums itself: no host sync, no extra launch.
// A CTA's range may span rows; each (CTA, row) piece is a segment, streamed
// through K1's ring with K1's copies, scores and per-warp online softmax
// (stream_segment, decode_attention.cuh) and merged over the CTA's warps
// (merge_warps). A segment that is a whole row normalizes and writes it, as
// K1 does. Any other writes its (m, l, acc) in f32 to workspace slot c + r
// (distinct for every segment: at most G + E - 1 slots), then takes a ticket
// of its row (__threadfence, atomicAdd); the row's last segment merges the
// row's partials in slot order, so that the bits do not depend on which CTA
// came last, writes the row and puts the ticket back to 0 for the next call.
// CTAs striding over the rows write the empty rows' zeros. One launch, no
// cluster, no cap on S.
//
// The kernel before this design (one 256-thread CTA a (row, chunk), keys
// read one element a thread a d row into a score row in shared memory, no
// copy ring, a second launch to merge) read 2-3x the byte bound and refused
// a block_s whose chunk overflowed shared memory.
#include "decode_attention.cuh"

namespace {

// The group's inclusive prefix sum of v over its threads in order; total:
// the sum over all of them. sh: a word a warp of shared memory.
__device__ __forceinline__ int group_scan(int v, int* sh, int gt, int gthreads, int& total) {
  const int lane = gt & 31, w = gt >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) sh[w] = v;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int j = 0; j < gthreads >> 5; ++j) {
    const int s = sh[j];
    if (j < w) before += s;
    total += s;
  }
  __syncthreads();
  return v + before;
}

// The few-row form: a CTA is one row group of a.wr warps (a.rows = 1,
// a.split = 1); ws holds the partials' slots (16 + round16(4 dv) bytes
// each), tickets E zeroed words.
template <typename TQ, typename TKV, int QPL>
__device__ __forceinline__ void decode_balanced(const Args& a, float* ws, int* tickets) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(sizeof(TKV), QPL, a.dk, a.dv, a.wr, a.stages);
  const int Tg = L.Tg, pf = L.part / 4;  // floats a partial
  const int gt = threadIdx.x, gthreads = a.wr * 32, wi = gt >> 5;
  const int c = blockIdx.x, G = gridDim.x;
  TQ* out = static_cast<TQ*>(a.out);
  // until the first segment's copies, the ring's first bytes hold the scan's
  // words and the row that holds the CTA's first tile
  int* sh = reinterpret_cast<int*>(smem);
  long long* found = reinterpret_cast<long long*>(smem + 64);
  auto row_len = [&](int r) { return a.lengths != nullptr ? a.lengths[r] : a.scalar_len; };
  auto tiles = [&](int r) {  // row r's valid group tiles
    const int len = row_len(r);
    return len <= 0 ? 0 : (min(len, a.S) + Tg - 1) / Tg;
  };

  long long T = 0;
  for (int r0 = 0; r0 < a.E; r0 += gthreads) {
    int total;
    group_scan(r0 + gt < a.E ? tiles(r0 + gt) : 0, sh, gt, gthreads, total);
    T += total;
  }
  for (int r = c; r < a.E; r += G)  // an empty row: 0, as the Pallas body
    if (tiles(r) == 0)
      for (int col = gt; col < a.dv; col += gthreads)
        out[static_cast<long long>(r) * a.dv + col] = from_f32<TQ>(0.f);
  const long long Ga = min(static_cast<long long>(G), T);  // CTAs with work, a tile at least
  if (c >= Ga) return;
  const long long t0 = c * T / Ga, t1 = (c + 1) * T / Ga;
  auto cta_of = [&](long long t) { return static_cast<int>(((t + 1) * Ga - 1) / T); };

  long long carry = 0;
  for (int r0 = 0; r0 < a.E && carry <= t0; r0 += gthreads) {
    const int r = r0 + gt, t = r < a.E ? tiles(r) : 0;
    int total;
    const long long start = carry + group_scan(t, sh, gt, gthreads, total) - t;
    if (t > 0 && start <= t0 && t0 < start + t) found[0] = r, found[1] = start;
    carry += total;
  }
  __syncthreads();
  int r = static_cast<int>(found[0]);
  long long rs = found[1];  // row r's first tile
  __syncthreads();  // read before the first copies land there

  while (rs < t1) {
    const int nt = tiles(r);
    if (nt > 0) {
      const int first = static_cast<int>(max(t0, rs) - rs);
      const int count = static_cast<int>(min(t1, rs + nt) - rs) - first;
      const int n = min(row_len(r), a.S);
      stream_segment<TQ, TKV, QPL, FMT_K1>(a, L, smem, Segment{r, n, n, first, count, true}, 0,
                                           wi, gt, gthreads);
      __syncthreads();
      const float* p0 = reinterpret_cast<const float*>(smem);
      TQ* orow = out + static_cast<long long>(r) * a.dv;
      float M = -INFINITY, lsum = 0.f;
      if (count == nt) {  // the whole row: normalized in place, as K1
        merge_warps(a, p0, pf, gt, gthreads, M, lsum,
                    [&](int col, float o, float inv) { orow[col] = from_f32<TQ>(o * inv); });
      } else {
        float* slot = ws + static_cast<long long>(c + r) * pf;
        merge_warps(a, p0, pf, gt, gthreads, M, lsum,
                    [&](int col, float o, float) { slot[4 + col] = o; });
        if (gt == 0) slot[0] = M, slot[1] = lsum;
        __threadfence();
        __syncthreads();
        const int c0 = cta_of(rs), segs = cta_of(rs + nt - 1) - c0 + 1;
        int* last = reinterpret_cast<int*>(smem + L.q_off);  // q is read by now
        if (gt == 0) *last = atomicAdd(tickets + r, 1) == segs - 1;
        __syncthreads();
        if (*last) {  // the row's partials in slot order, the CTAs' order
          __threadfence();
          const float* s0 = ws + static_cast<long long>(c0 + r) * pf;
          auto weight = [&](int j, float Mr) {
            const float m = __ldcg(s0 + j * pf);
            return m == -INFINITY ? 0.f : __expf(m - Mr);
          };
          float Mr = -INFINITY, lr = 0.f;
          for (int j = 0; j < segs; ++j) Mr = fmaxf(Mr, __ldcg(s0 + j * pf));
          for (int j = 0; j < segs; ++j) lr = fmaf(__ldcg(s0 + j * pf + 1), weight(j, Mr), lr);
          const float inv = lr > 0.f ? 1.f / lr : 0.f;
          for (int col = gt; col < a.dv; col += gthreads) {
            float o = 0.f;
            for (int j = 0; j < segs; ++j) o = fmaf(__ldcg(s0 + j * pf + 4 + col), weight(j, Mr), o);
            orow[col] = from_f32<TQ>(o * inv);
          }
          if (gt == 0) tickets[r] = 0;
        }
      }
      __syncthreads();  // the partials and the ticket word read before the next copies
    }
    rs += nt;
    ++r;
  }
}

template <typename TQ, typename TKV, int QPL>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
decode_gathered_kernel(const Args a, float* ws, int* tickets) {
  decode_balanced<TQ, TKV, QPL>(a, ws, tickets);
}

struct Launch {
  float* ws;
  int* tickets;
  unsigned grid;

  template <auto Kern>
  cudaError_t launch(const Args& a, int elt, int qpl, cudaStream_t st) const {
    const Layout L(elt, qpl, a.dk, a.dv, a.wr, a.stages);
    if ((L.Tg * elt) % 16 || a.rows != 1 || a.split != 1 || L.group > 232448)
      return cudaErrorInvalidValue;
    const cudaError_t err = allow_smem<Kern>(232448);
    if (err != cudaSuccess) return err;
    auto kernel = Kern;
    kernel<<<grid, a.wr * 32, L.group, st>>>(a, ws, tickets);
    return cudaGetLastError();
  }

  template <typename TQ, typename TKV>
  cudaError_t run(const Args& a, long long qpl, cudaStream_t st) const {
    constexpr int elt = sizeof(TKV);
    switch (qpl) {
      case 1: return launch<decode_gathered_kernel<TQ, TKV, 1>>(a, elt, 1, st);
      case 2: return launch<decode_gathered_kernel<TQ, TKV, 2>>(a, elt, 2, st);
      case 4: return launch<decode_gathered_kernel<TQ, TKV, 4>>(a, elt, 4, st);
      case 6: return launch<decode_gathered_kernel<TQ, TKV, 6>>(a, elt, 6, st);
      case 8: return launch<decode_gathered_kernel<TQ, TKV, 8>>(a, elt, 8, st);
      default: return cudaErrorInvalidValue;
    }
  }
};

}  // namespace

// The few-row launch of ops/decode_attention.py _gathered_schedule: `grid`
// CTAs of one row group of `warps` warps, `stages` ring stages, qpl column
// quads a lane; ws the partials' f32 slots (grid + E - 1 of 4 + round4(dv)
// floats), tickets E int32 words that are 0 (and are 0 again after the
// launch). K1's launch, for many rows, is decode_attention_launch.
extern "C" int decode_attention_gathered_launch(
    const void* q, const void* kt, const void* ks, const void* v, const void* vs,
    const void* lengths, void* out, void* ws, void* tickets, long long E, long long dk,
    long long S, long long dv, long long scalar_len, long long q_se, long long kt_se,
    long long kt_sd, long long v_se, long long v_ss, long long ks_se, long long vs_se,
    long long q_dtype, long long kv_dtype, long long qpl, long long warps, long long stages,
    long long grid, void* stream) {
  if (grid < 1 || ws == nullptr || tickets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch launch{static_cast<float*>(ws), static_cast<int*>(tickets),
                      static_cast<unsigned>(grid)};
  return k1_entry(launch, FMT_K1, q, kt, ks, v, vs, lengths, out, nullptr, nullptr, E, dk, S, dv,
                  scalar_len, q_se, kt_se, kt_sd, v_se, v_ss, ks_se, vs_se, q_dtype, kv_dtype, qpl,
                  warps, 1, 1, stages, stream);
}
