// K8: single-query decode attention over the low-bit (int4 pair-packed) caches.
//
// Replaces the TPU kernels backpacks_flash_attn_tpu/ops/decode_attention.py
// decode_attention_int4_blockdiag (:667, _blockdiag_int4_kernel :658),
// decode_attention_mixed_blockdiag (:808, _blockdiag_mixed_kernel :796) and the stacked
// forms behind _stacked_call (:933; _stacked_int4_kernel :892, _stacked_mixed_kernel :911),
// which all run _lowbit_decode_body (:567). For each row e, with packed column j holding
// positions 2j (low nibble) and 2j+1 (high nibble):
//   s_even[j] = (q . k_lo[:, j]) * ks2[e, 0, j]    for 2j   < len
//   s_odd[j]  = (q . k_hi[:, j]) * ks2[e, 1, j]    for 2j+1 < len
//   p = one softmax over both score vectors together
//   out = sum_j p_even[j] vs2[e, 0, j] v_lo[j, :] + p_odd[j] vs2[e, 1, j] v_hi[j, :]
// Two key formats: pair-packed nibbles (kt4 (E, dk, S/2), FMT_INT4) and int8 in the
// even/odd split layout (k8 (E, dk, 2, S/2), FMT_MIXED, the mixed Backpack cache).
// Values are always pair-packed (E, S/2, dv); scales (E, 2, S/2) f32.
//
// Bound on the H100: memory. A valid position costs dk/2 + dv/2 bytes of packed cache (dk
// for split int8 keys) plus 8 bytes of scales, read once at about 4 flops a byte (twice
// K1's INT8 rate: two values a byte), so the least time is bytes / 3.35 TB/s; at the GPT
// rows a call moves ~14 MB, and the launch and one DRAM round trip weigh as much.
//
// Design: K1's (decode_attention.cu), whose body this kernel shares through
// decode_attention.cuh: the int4 layouts are K1's INT8 ones with two positions to a byte.
// The warps of a row share a cp.async ring and stream the row's valid packed prefix
// ceil(len / 2) in group tiles (a tile's keys, values and four scale runs one commit
// group), a key row of a tile one contiguous run of 16-byte copies (two runs for the
// mixed cache), each warp its own slice of every tile with its own online softmax over
// both parities, merged in a fixed order; no score row in shared memory and so no cap on
// S. A lane decodes a 4-byte word at a time in registers (8 key nibbles, or 4 value
// channels x 2 positions), the nibbles moved by __byte_perm into the mantissa of 128 with
// their offset taken off the sums once. A warp takes 32 packed columns of a narrow row
// (32 bytes of keys a d row, as K1's INT8 warps), 8 of a wide one. The serve's rows are
// short (64 or 128 packed columns under its windows) and a row's work small, so the
// launch shape (ops/decode_attention.py _k8_schedule) puts several rows of 2 warps in
// a CTA, which fits more rows on an SM (4 narrow rows; 2 wide ones, 1 row of 4 warps
// past 128 packed columns), and where the rows are too few to fill the SMs, K1's 8
// warps a row with S split over a thread-block cluster. Every operand is addressed through its strides, so
// a layer of a stacked cache and a window slice cost no copy.
//
// K8-ml, the (m, l) form (mo, lo non-null), replaces _stacked_call(return_ml=True) (:990,
// _stacked_int4_ml_kernel :922, the mo_ref/lo_ref epilogue of _lowbit_decode_body :651)
// behind decode_attention_int4_staged_ml (:1205): the main segment of the staged low-bit
// serving decode, valid below base_len, merged with a segment over the int8 staging block.
// It also writes each row's softmax state: m = the max over the valid scores of BOTH
// parities (taken before any exp), l = sum exp(s - m) over the same positions with that
// same m, in the units of the scores above. A row with no valid position returns
// (0, NEG, 0), as the Pallas body does, and the merge weighs it out. Without (m, l) a row
// of length 0 attends uniformly over all S positions, as the dispatcher's masked softmax.
//
// The kernel before this design (one 256-thread CTA a row, keys one byte a thread per d
// row, the score row in shared memory between three phases and two block reductions, a
// serial dv epilogue) capped S/2 at 4096.
#include "decode_attention.cuh"

namespace {

// narrow rows (QPL 1) held to 80 registers, so that their CTAs fit an SM three
// (two) at a time by registers as by shared memory
template <typename TQ, int QPL, bool kSplit>
__global__ void __launch_bounds__(kMaxWarps * 32, QPL == 1 ? 3 : 2)
lowbit_decode_attn_kernel(const Args a) {
  decode_rows<TQ, int8_t, QPL, kSplit ? FMT_MIXED : FMT_INT4>(a);
}

template <typename TQ, bool kSplit>
cudaError_t launch_qpl(const Args& a, long long qpl, cudaStream_t st) {
  constexpr int fmt = kSplit ? FMT_MIXED : FMT_INT4;
  switch (qpl) {
    case 1: return launch_rows<lowbit_decode_attn_kernel<TQ, 1, kSplit>>(a, 1, 1, fmt, st);
    case 2: return launch_rows<lowbit_decode_attn_kernel<TQ, 2, kSplit>>(a, 1, 2, fmt, st);
    case 4: return launch_rows<lowbit_decode_attn_kernel<TQ, 4, kSplit>>(a, 1, 4, fmt, st);
    case 6: return launch_rows<lowbit_decode_attn_kernel<TQ, 6, kSplit>>(a, 1, 6, fmt, st);
    case 8: return launch_rows<lowbit_decode_attn_kernel<TQ, 8, kSplit>>(a, 1, 8, fmt, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// S2 packed columns; k_sp: the mixed keys' odd run (0 for int4 keys); ks_sp, vs_sp:
// the scales' parity strides. The launch shape (qpl, warps, rows, split, stages) as
// decode_attention_launch takes it, from ops/decode_attention.py _k8_schedule.
extern "C" int lowbit_decode_attention_launch(
    const void* q, const void* keys, const void* ks2, const void* v4, const void* vs2,
    const void* lengths, void* out, void* mo, void* lo, long long E, long long dk,
    long long S2, long long dv, long long scalar_len, long long q_se, long long k_se,
    long long k_sd, long long k_sp, long long ks_se, long long ks_sp, long long v_se,
    long long v_ss, long long vs_se, long long vs_sp, long long q_dtype, long long split_keys,
    long long qpl, long long warps, long long rows, long long split, long long stages,
    void* stream) {
  if (!schedule_ok(warps, rows, split, stages, dk, dv, qpl) || dv % 16 ||
      (mo == nullptr) != (lo == nullptr) || ks2 == nullptr || vs2 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0) return 0;
  Args a;
  a.q = q, a.kt = keys, a.ks = static_cast<const float*>(ks2), a.v = v4;
  a.vs = static_cast<const float*>(vs2), a.lengths = static_cast<const int*>(lengths);
  a.out = out, a.mo = static_cast<float*>(mo), a.lo = static_cast<float*>(lo);
  a.q_se = q_se, a.kt_se = k_se, a.kt_sd = k_sd, a.v_se = v_se, a.v_ss = v_ss;
  a.ks_se = ks_se, a.vs_se = vs_se, a.k_sp = split_keys ? k_sp : 0, a.ks_sp = ks_sp;
  a.vs_sp = vs_sp;
  a.E = static_cast<int>(E), a.dk = static_cast<int>(dk), a.S = static_cast<int>(S2);
  a.dv = static_cast<int>(dv), a.scalar_len = static_cast<int>(scalar_len);
  a.rows = static_cast<int>(rows), a.wr = static_cast<int>(warps / rows);
  a.split = static_cast<int>(split), a.stages = static_cast<int>(stages);
  a.kvec = aligned(keys, 16) && k_se % 16 == 0 && k_sd % 16 == 0 &&
           (!split_keys || k_sp % 16 == 0);
  a.vvec = aligned(v4, 16) && v_se % 16 == 0 && v_ss % 16 == 0;
  a.vflat = a.vvec && v_ss == dv;
  a.ksvec = aligned(ks2, 16) && ks_se % 4 == 0 && ks_sp % 4 == 0;
  a.vsvec = aligned(vs2, 16) && vs_se % 4 == 0 && vs_sp % 4 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == DT_BF16)
    err = split_keys ? launch_qpl<__nv_bfloat16, true>(a, qpl, st)
                     : launch_qpl<__nv_bfloat16, false>(a, qpl, st);
  else if (q_dtype == DT_F32)
    err = split_keys ? launch_qpl<float, true>(a, qpl, st) : launch_qpl<float, false>(a, qpl, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
