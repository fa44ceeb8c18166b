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
//
// The kernel body with its ring, copies and merge lives in
// decode_attention.cuh, which K8 (lowbit_decode_attention.cu) shares over
// its low-bit layouts and K1-selector (decode_attention_selector.cu) over
// (E, dv, S) values.
//
// K1-blockdiag is this kernel too. It replaces the TPU kernel
// decode_attention_blockdiag (decode_attention.py:465, Pallas body
// _blockdiag_kernel :415), which computes K1's function with the per-row
// matvecs turned into block-diagonal MXU products over JAX's rows a program
// (:475-481). At ~2 flops a byte the H100 needs no such trick, so the op
// wrapper launches this entry on K1's schedule (counted apart, as
// decode_attention_blockdiag); JAX's rows a program choose nothing here.
#include "decode_attention.cuh"

namespace {

template <typename TQ, typename TKV, int QPL>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
decode_attention_kernel(const Args a) {
  decode_rows<TQ, TKV, QPL, FMT_K1>(a);
}

struct Launch {
  template <typename TQ, typename TKV>
  static cudaError_t run(const Args& a, long long qpl, cudaStream_t st) {
    constexpr int elt = sizeof(TKV);
    switch (qpl) {
      case 1: return launch_rows<decode_attention_kernel<TQ, TKV, 1>>(a, elt, 1, FMT_K1, st);
      case 2: return launch_rows<decode_attention_kernel<TQ, TKV, 2>>(a, elt, 2, FMT_K1, st);
      case 4: return launch_rows<decode_attention_kernel<TQ, TKV, 4>>(a, elt, 4, FMT_K1, st);
      case 6: return launch_rows<decode_attention_kernel<TQ, TKV, 6>>(a, elt, 6, FMT_K1, st);
      case 8: return launch_rows<decode_attention_kernel<TQ, TKV, 8>>(a, elt, 8, FMT_K1, st);
      default: return cudaErrorInvalidValue;
    }
  }
};

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
  return k1_entry(Launch{}, FMT_K1, q, kt, ks, v, vs, lengths, out, mo, lo, E, dk, S, dv,
                  scalar_len, q_se, kt_se, kt_sd, v_se, v_ss, ks_se, vs_se, q_dtype, kv_dtype, qpl,
                  warps, rows, split, stages, stream);
}
