// K1-selector: single-query decode attention over values stored transposed.
//
// Replaces the TPU kernel backpacks_flash_attn_tpu/ops/decode_attention.py
// decode_attention_selector (:365, Pallas body _selector_kernel :311). It
// computes K1's function (decode_attention.cu):
//   out[e] = softmax_{s < len[e]}((q[e] . kt[e,:,s]) * ks[e,s]) * vs[e,s] @ v[e,:,s]^T
// with the values in the selector's production layout (E, dv, S) (:365-379):
// any outer strides, unit stride along S, any dv >= 1. The TPU body turns
// the per-row matvecs into 0/1 selector products for the MXU; a row of
// length 0 attends uniformly over all S, as its masked softmax does.
//
// Bound on the H100: memory, as K1 (~2 flops a byte read).
//
// Design: K1's kernel body (decode_attention.cuh, decode_rows) over the
// value-transposed format FMT_VT, on K1's schedule (ops/decode_attention.py
// _k1_schedule with vt): the warps of a row share a cp.async ring and stream
// the row's valid prefix in group tiles of Tg positions, each warp its own
// slice with its own online softmax, merged in a fixed order; S split over a
// cluster where the rows are few; no score row in shared memory and so no
// cap on S. A tile's values arrive as dv channel runs of Tg positions, 16-byte
// copies along s, one slab row a channel, rows ordered by c % 4 then c / 4
// and their chunks swizzled, so that the lanes of one load, each on a
// channel of its own quad, hit distinct banks (the wide rows' 8-byte loads
// two to a bank). A lane reads a 16- or 8-byte unit of positions of each of
// its channels and the unit's weights once, 4-16 FMAs a load, into K1's
// accumulator layout; the merge and epilogue are K1's. The channel runs are
// Tg x elt bytes: 128 or 256 at narrow rows; wide rows (the Backpack
// combine's dv 768) take 8 warps a row, not K1's 4, so that their runs are
// 64 bytes, not 32 (768 runs a tile at a stride of S: the 32-byte runs read
// the combine at 2.6x K1's time, the 64-byte ones at 1.4x; probe_selector.py
// and PERF.md).

#include "decode_attention.cuh"

namespace {

template <typename TQ, typename TKV, int QPL>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
decode_selector_kernel(const Args a) {
  decode_rows<TQ, TKV, QPL, FMT_VT>(a);
}

struct Launch {
  template <typename TQ, typename TKV>
  static cudaError_t run(const Args& a, long long qpl, cudaStream_t st) {
    constexpr int elt = sizeof(TKV);
    switch (qpl) {
      case 1: return launch_rows<decode_selector_kernel<TQ, TKV, 1>>(a, elt, 1, FMT_VT, st);
      case 2: return launch_rows<decode_selector_kernel<TQ, TKV, 2>>(a, elt, 2, FMT_VT, st);
      case 4: return launch_rows<decode_selector_kernel<TQ, TKV, 4>>(a, elt, 4, FMT_VT, st);
      case 6: return launch_rows<decode_selector_kernel<TQ, TKV, 6>>(a, elt, 6, FMT_VT, st);
      case 8: return launch_rows<decode_selector_kernel<TQ, TKV, 8>>(a, elt, 8, FMT_VT, st);
      default: return cudaErrorInvalidValue;
    }
  }
};

}  // namespace

// K1's C entry (decode_attention_launch) over values (E, dv, S): v_sd the
// stride of a channel; the launch shape from _k1_schedule(..., vt=True).
extern "C" int decode_attention_selector_launch(
    const void* q, const void* kt, const void* ks, const void* v, const void* vs,
    const void* lengths, void* out, void* mo, void* lo, long long E, long long dk, long long S,
    long long dv, long long scalar_len, long long q_se, long long kt_se, long long kt_sd,
    long long v_se, long long v_sd, long long ks_se, long long vs_se, long long q_dtype,
    long long kv_dtype, long long qpl, long long warps, long long rows, long long split,
    long long stages, void* stream) {
  return k1_entry(Launch{}, FMT_VT, q, kt, ks, v, vs, lengths, out, mo, lo, E, dk, S, dv,
                  scalar_len, q_se, kt_se, kt_sd, v_se, v_sd, ks_se, vs_se, q_dtype, kv_dtype, qpl,
                  warps, rows, split, stages, stream);
}
