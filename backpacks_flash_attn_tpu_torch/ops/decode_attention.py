"""Single-query decode attention over INT8 caches (kernel K1 and its three
redesigns) and over the low-bit int4 and mixed caches (kernel K8), and the
staged serving decode.

Port of ``backpacks_flash_attn_tpu/ops/decode_attention.py``: the contract
of ``decode_attention_fused`` (:77), ``decode_attention_ref`` (:117) and
``decode_attention_flat`` (:134), plus ``decode_attention_flat_multi``
(:1065) in plain PyTorch; K1's redesigns ``decode_attention_gathered``
(:238), ``decode_attention_selector`` (:365) and
``decode_attention_blockdiag`` (:465); the low-bit section below ports the
int4 and mixed forms (:520-1062), the staged section the two-segment decode
of the serving cache (:1097-1279). K1's shapes (E = batch * heads, one
problem per row):

  q:  (E, dk)        bf16/f32, pre-scaled by the softmax scale
  kt: (E, dk, S)     int8/bf16/f32 — the key cache stored TRANSPOSED
  ks: (E, S) f32     per-position key dequant scales, or None
  v:  (E, S, dv)     same dtype as kt (dv may differ from dk: the Backpack
                     alpha @ content contraction has dk = 64, dv = d)
  vs: (E, S) f32     or None
  length: int or (E,) int32 — valid cache length per row
Returns (E, dv) in q's dtype.

``kt``/``v``/``ks``/``vs`` may be window slices of a larger cache (any outer
strides, unit inner stride): the kernel reads only the valid prefix of each
row, so the window costs no copy.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _build, quant

NEG = -1e30
_K1 = {False: _build.KERNELS["decode_attention"],
       True: _build.KERNELS["decode_attention_ml"]}
_K8 = {False: _build.KERNELS["lowbit_decode_int4"],
       True: _build.KERNELS["lowbit_decode_mixed"]}
_K8_ML = _build.KERNELS["lowbit_decode_int4_ml"]
_GATHERED = _build.KERNELS["decode_attention_gathered"]
_SELECTOR = _build.KERNELS["decode_attention_selector"]
_BLOCKDIAG = _build.KERNELS["decode_attention_blockdiag"]
# dynamic shared memory a block may take on the H100 (227 KB)
_SMEM_BYTES = 232448
_KV_DTYPES = {torch.bfloat16: (torch.int8, torch.bfloat16),
              torch.float32: (torch.int8, torch.float32)}


def _row_lengths(length, e: int, device) -> torch.Tensor:
    if isinstance(length, int):
        return torch.full((e,), length, dtype=torch.int64, device=device)
    return torch.as_tensor(length, device=device).reshape(-1).expand(e)


def _compute_dtype(q: torch.Tensor):
    return torch.float32 if q.dtype == torch.float32 else torch.bfloat16


def _lengths_arg(length, e: int, device):
    """(lengths tensor or None, scalar length) as the kernels take them."""
    if isinstance(length, int):
        return None, length
    lens = torch.as_tensor(length, device=device).to(torch.int32)
    return lens.reshape(-1).expand(e).contiguous(), 0


def _ml_outputs(e: int, device):
    """The (m, l) outputs of a kernel's (m, l) form: f32 (E, 1) views."""
    ml = torch.empty((2, e, 1), dtype=torch.float32, device=device)
    return ml[0], ml[1]


def _segment(s, ok, vs, v, cdt, out_dtype):
    """The normalized output and (m, l) of one softmax segment: s (E, n)
    f32 scores, ok (E, n) valid, vs (E, n) value scales or None, v
    (E, n, dv). The Pallas body's epilogue (:617-655): m over the valid
    scores, exp(s - m) zeroed where invalid, l their sum; an all-masked row
    returns (0, NEG, 0)."""
    s = torch.where(ok, s, NEG)
    m = s.amax(dim=1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(dim=1, keepdim=True)
    if vs is not None:
        p = p * vs
    o = torch.einsum("es,esd->ed", p.to(cdt), v.to(cdt)).float()
    return (o / torch.where(l == 0.0, 1.0, l)).to(out_dtype), m, l


def decode_attention_ref(q, kt, ks, v, vs, length):
    """Plain version of K1. The two contractions run in the working dtype
    (bf16 operands, as the TPU's production ``decode_attention_flat``), the
    softmax in f32; with f32 inputs this is JAX's ``decode_attention_ref``."""
    cdt = _compute_dtype(q)
    s = torch.einsum("ed,eds->es", q.to(cdt), kt.to(cdt)).float()
    if ks is not None:
        s = s * ks
    pos = torch.arange(v.shape[1], device=q.device)[None, :]
    lengths = _row_lengths(length, q.shape[0], q.device)
    s = torch.where(pos < lengths[:, None], s, NEG)
    p = torch.softmax(s, dim=-1)
    if vs is not None:
        p = p * vs
    return torch.einsum("es,esd->ed", p.to(cdt), v.to(cdt)).to(q.dtype)


def decode_attention_ml_ref(q, kt, ks, v, vs, length):
    """Plain version of K1's (m, l) form: (out, m, l), m and l f32 (E, 1),
    the softmax state of the row in the units of the scores (q pre-scaled,
    times ks). An all-masked row returns (0, NEG, 0)."""
    cdt = _compute_dtype(q)
    s = torch.einsum("ed,eds->es", q.to(cdt), kt.to(cdt)).float()
    if ks is not None:
        s = s * ks
    pos = torch.arange(v.shape[1], device=q.device)[None, :]
    ok = pos < _row_lengths(length, q.shape[0], q.device)[:, None]
    return _segment(s, ok, vs, v, cdt, q.dtype)


def decode_attention(q: torch.Tensor, kt: torch.Tensor,
                     ks: Optional[torch.Tensor], v: torch.Tensor,
                     vs: Optional[torch.Tensor], length) -> torch.Tensor:
    """Single-step cache attention (K1, ``csrc/decode_attention.cu``). CPU
    tensors, and every call inside ``_build.plain_path()``, take
    :func:`decode_attention_ref`; otherwise a CUDA tensor launches the
    kernel or raises."""
    if not q.is_cuda or not _build.kernels_enabled():
        return decode_attention_ref(q, kt, ks, v, vs, length)
    return _k1_kernel(q, kt, ks, v, vs, length, ml=False)


def decode_attention_ml(q, kt, ks, v, vs, length):
    """K1's (m, l) form, the main segment of the staged decode: (out, m, l)
    as :func:`decode_attention_ml_ref` (counted as ``decode_attention_ml``).
    Dispatch as in :func:`decode_attention`."""
    if not q.is_cuda or not _build.kernels_enabled():
        return decode_attention_ml_ref(q, kt, ks, v, vs, length)
    return _k1_kernel(q, kt, ks, v, vs, length, ml=True)


def _check_no_grad(name: str, *operands) -> None:
    """The decode kernels have no backward (nor have the JAX package's):
    a launch inside a graph that asks for a gradient through an operand
    would return an output cut off from it. Raise instead, naming the way
    out."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in operands):
        raise RuntimeError(
            f"{name}: an operand requires grad, but the decode kernels have "
            "no backward; take the gradient through the plain version "
            "(inside ops._build.plain_path()) or call under torch.no_grad()")


def _check_operands(q, kt, ks, v, vs, name: str, v_transposed: bool = False):
    """Validate K1's operands (and its redesigns'): -> (E, dk, S, dv)."""
    _check_no_grad(name, q, kt, ks, v, vs)
    e, dk = q.shape
    _build.check_cuda_tensor("q", q, _KV_DTYPES.keys(), 2)
    _build.check_cuda_tensor("kt", kt, _KV_DTYPES[q.dtype], 3)
    _build.check_cuda_tensor("v", v, (kt.dtype,), 3)
    s_len, dv = (v.shape[2], v.shape[1]) if v_transposed else (v.shape[1], v.shape[2])
    if kt.shape != (e, dk, s_len) or v.shape[0] != e:
        raise ValueError(f"shapes q {tuple(q.shape)} kt {tuple(kt.shape)} "
                         f"v {tuple(v.shape)} disagree")
    for sname, sc in (("ks", ks), ("vs", vs)):
        if sc is not None:
            _build.check_cuda_tensor(sname, sc, (torch.float32,), 2)
            if sc.shape != (e, s_len):
                raise ValueError(f"{sname} shape {tuple(sc.shape)} != "
                                 f"{(e, s_len)}")
    if dk > 256 or dv > 1024 or (not v_transposed and dv % 4):
        raise ValueError(f"{name} kernel takes dk <= 256, dv <= 1024 (a "
                         f"multiple of 4 over (E, S, dv) values); got dk={dk} "
                         f"dv={dv}")
    vec_bytes = 4 * v.element_size()
    if not v_transposed and (v.data_ptr() % vec_bytes or v.stride(0) % 4
                             or v.stride(1) % 4):
        raise ValueError(f"{name} kernel needs 4-element aligned value rows")
    return e, dk, s_len, dv


def _scale_strides(ks, vs):
    return (ks.stride(0) if ks is not None else 0,
            vs.stride(0) if vs is not None else 0)


# K1's launch shape (csrc/decode_attention.cu): shared memory an SM and a
# block may take on the H100, and what the card reserves a block
_SM_SMEM, _BLOCK_SMEM, _SMEM_RESERVED = 233472, _SMEM_BYTES, 1024
_K1_MAX_SPLIT = 8


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _k1_warp_tile(qpl: int, elt: int) -> int:
    """Columns of a group tile one K1 (or K8) warp owns: 32 bytes of keys a
    d row for narrow rows (qpl 1), 8 for wide ones; at least 4 (K8: packed
    columns of one byte)."""
    return max(4, (32 if qpl == 1 else 8) // elt)


def _k1_group_bytes(qpl: int, dk: int, dv: int, elt: int, wr: int, stages: int,
                    kr: int = 1, np_: int = 1, vt: bool = False) -> int:
    """Shared memory of one K1 (or K8, or selector) row group of ``wr``
    warps (the kernel's ``Layout``, csrc/decode_attention.cuh): ``stages``
    ring stages [keys kr x dk x Tg | values Tg x dv (16-byte rows) | ks, vs
    np_ x Tg f32], q (dk f32) and each warp's probabilities (np_ x Tw f32),
    Tg = wr x Tw columns. K8: a column is a packed column (np_ = 2
    positions, one byte), kr = 2 key runs over the mixed cache. ``vt`` (the
    selector's (E, dv, S) values): round4(dv) channel rows of round16(Tg x
    elt) bytes."""
    tw, p = _k1_warp_tile(qpl, elt), 16 // elt
    tg, dvp = wr * tw, -(-dv // p) * p
    values = -(-dv // 4) * 4 * _round16(tg * elt) if vt else _round16(tg * dvp * elt)
    stage = _round16(_round16(kr * dk * tg * elt) + values + 8 * np_ * tg)
    return stages * stage + _round16(4 * dk) + wr * _round16(4 * np_ * tw)


def _quads(dv: int) -> int:
    """qpl: the fewest 4-column quads a lane that cover dv (1, 2, 4, 6, 8)."""
    return next(c for c in (1, 2, 4, 6, 8) if 32 * c >= -(-dv // 4))


def _row_schedule(e: int, dk: int, dv: int, s_len: int, elt: int, sms: int,
                  wr: int, rows: int, kr: int = 1, np_: int = 1, stages=None,
                  vt: bool = False):
    """The rest of the launch shape K1 and K8 share, for CTAs of ``rows``
    rows of ``wr`` warps over ``s_len`` columns: fewer rows, then fewer
    warps, while a CTA's ring of 2 stages does not fit a block; S split over
    a cluster where the CTAs leave SMs idle (see :func:`_k1_schedule`); and,
    unless given, the deepest ring (2-4 stages) with which as many CTAs fit
    an SM as the grid puts there (at most 3). ``vt``: the selector's
    value-transposed layout."""
    qpl = _quads(dv)
    group = lambda w, st: _k1_group_bytes(qpl, dk, dv, elt, w, st, kr, np_, vt)
    while rows > 1 and rows * group(wr, 2) > _BLOCK_SMEM:
        rows //= 2
    while wr > 2 and group(wr, 2) > _BLOCK_SMEM:   # K8's split int8 keys at large dk
        wr //= 2
    split = 1
    tiles = -(-s_len // (wr * _k1_warp_tile(qpl, elt)))
    while -(-e // rows) * split < sms and split < _K1_MAX_SPLIT and 4 * split <= tiles:
        split *= 2
    if stages is None:
        per_sm = min(3, -(-(-(-e // rows) * split) // sms))
        stages = 2
        for s in (4, 3):
            if per_sm * (rows * group(wr, s) + _SMEM_RESERVED) <= _SM_SMEM:
                stages = s
                break
    return qpl, wr * rows, rows, split, stages


@functools.lru_cache(maxsize=None)
def _k1_schedule(e: int, dk: int, dv: int, s_len: int, elt: int, sms: int = 132,
                 vt: bool = False):
    """K1's launch shape for E rows of an S-wide cache of ``elt``-byte
    elements on a card of ``sms`` SMs: ``(qpl, warps, rows, split,
    stages)``; ``vt``: values (E, dv, S), the selector's layout: its ring is
    K1's size where dv values fill whole 16-byte chunks, and its wide rows
    take 8 warps (see below).

    The ``warps / rows`` warps of a row share a cp.async ring of
    ``stages`` stages and stream the row in group tiles, each warp its own
    slice of every tile with its own online softmax; the row's warps, and
    the ``split`` CTAs of its cluster, merge at the end. ``qpl`` is the
    4-column quads of dv a lane accumulates: narrow rows (dv <= 128) take
    one and 32 bytes of keys a d row a warp; wider rows 2, 4, 6 or 8 (the
    fewest that cover dv: 6 at the Backpack combine's 768) and 8 bytes.
    A row takes 4 warps (a key row of a narrow group tile is then one
    128-byte run). A CTA of narrow rows takes 2 rows, or 1 row of 8 warps
    (256-byte runs) when the rows are fewer than two an SM, or when two
    rows' rings do not fit a block; a CTA of wide rows takes 1 row. Where
    one row a CTA still leaves SMs without one, S is split over a cluster
    of ``split`` CTAs (the least power of two that gives every SM a CTA, at
    most 8, and each CTA at least two group tiles at the full width). The
    ring takes the most stages (up to 4) with which as many CTAs fit an SM
    as the grid puts on one (at most 3), and at least 2. The selector's
    wide rows (``vt``) take 8 warps: a tile's values are then dv channel
    runs of 64 bytes (int8, bf16), where 4 warps' 32-byte runs read the
    Backpack combine at 1.6-1.8x the time (``probe_selector.py``, PERF.md)."""
    wr, rows = 4, (2 if _quads(dv) == 1 else 1)
    if _quads(dv) == 1 and -(-e // 2) < sms:
        wr, rows = 8, 1
    elif vt and _quads(dv) > 1:
        wr = 8
    return _row_schedule(e, dk, dv, s_len, elt, sms, wr, rows, vt=vt)


def _k1_kernel(q, kt, ks, v, vs, length, ml: bool = False, kernel=None,
               vt: bool = False, empty_zero: bool = False):
    """K1's C entry (counted as ``kernel``, by default K1 or K1-ml), or
    with ``vt`` the selector's over values (E, dv, S)
    (csrc/decode_attention_selector.cu); K1's schedule, any S.
    ``empty_zero``: a row of length 0 gives 0 (the (m, l) epilogue's
    output; m and l are dropped) instead of attending uniformly."""
    kernel = kernel or _K1[ml]
    e, dk, s_len, dv = _check_operands(q, kt, ks, v, vs, kernel.name, vt)
    lens, scalar_len = _lengths_arg(length, e, q.device)
    out = torch.empty((e, dv), dtype=q.dtype, device=q.device)
    m, l = _ml_outputs(e, q.device) if ml or empty_zero else (None, None)
    P = _build.Ptr.of
    code = _build.DTYPE_CODE
    _build.launch(
        kernel, "decode_attention_selector_launch" if vt else "decode_attention_launch",
        P(q), P(kt), P(ks), P(v), P(vs), P(lens), P(out), P(m), P(l), e, dk,
        s_len, dv, scalar_len, q.stride(0), kt.stride(0), kt.stride(1),
        v.stride(0), v.stride(1), *_scale_strides(ks, vs), code[q.dtype],
        code[kt.dtype],
        *_k1_schedule(e, dk, dv, s_len, kt.element_size(),
                      _build.sm_count(q.device.index), vt),
        library=_SELECTOR if vt else _K1[False])
    return (out, m, l) if ml else out


def decode_attention_flat(q, kt, ks, v, vs, length, *,
                          length_buckets: bool = False):
    """JAX's production decode contraction (:134), the contract of
    :func:`decode_attention`. ``length_buckets`` (JAX: read only the
    smallest of S/4, S/2, S covering the longest row) changes nothing here:
    K1 already reads only each row's valid prefix, and the plain version's
    masked columns add exact zeros, so the result equals
    ``length_buckets=False`` exactly (JAX's test of the flag:
    tests/ops/test_decode_attention.py:48)."""
    del length_buckets
    return decode_attention(q, kt, ks, v, vs, length)


# ------------------------------------------------------------ K1's redesigns
#
# The three TPU redesigns of K1 compute K1's function on other schedules,
# each counted apart (``decode_attention_gathered`` / ``_selector`` /
# ``_blockdiag``). On the card all three run K1's body with no cap on S: the
# gathered form over a length-balanced split of all rows' valid tiles
# (``csrc/decode_attention_gathered.cu``; K1's own launch where K1 needs no
# split), the selector over its (E, dv, S) values
# (``csrc/decode_attention_selector.cu``) on K1's schedule, and blockdiag as
# K1's kernel itself. Their plain versions follow the Pallas bodies'
# numerics in the working dtype: bf16 operands, products accumulated in f32,
# p cast to bf16 before the value product.

def _exact(t: torch.Tensor, cdt) -> torch.Tensor:
    """t rounded to the working dtype, as f32: a product of two such tensors
    accumulates in f32 exactly as a bf16 matrix unit with f32 sums does."""
    return t.to(cdt).float()


def _gathered_block(s_len: int, block_s: int) -> int:
    """JAX's block rule (:253-256): halve block_s (not below 128) until it
    divides S, else one block of the whole width."""
    while s_len % block_s != 0 and block_s > 128:
        block_s //= 2
    return block_s if s_len % block_s == 0 else s_len


def decode_attention_gathered_ref(q, kt, ks, v, vs, length, *,
                                  rows_per_program: int = 8,
                                  block_s: int = 128):
    """Plain version of K1-gathered (JAX ``_gathered_kernel`` :184): the
    online softmax over S-blocks of JAX's block width, in block order, with
    f32 state; a row of length 0 returns 0 (K1 attends uniformly there). A
    block past a row's length adds exactly 0 and rescales by exactly 1, so
    ``rows_per_program``'s grouping (which blocks JAX skips) cannot change
    the result and is accepted for JAX's signature only."""
    del rows_per_program
    cdt = _compute_dtype(q)
    e, s_len, dv = q.shape[0], v.shape[1], v.shape[2]
    bs = _gathered_block(s_len, block_s)
    lens = _row_lengths(length, e, q.device)[:, None]
    qc = _exact(q, cdt)
    acc = torch.zeros((e, dv), dtype=torch.float32, device=q.device)
    m = torch.full((e, 1), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((e, 1), dtype=torch.float32, device=q.device)
    for j0 in range(0, s_len, bs):
        blk = slice(j0, j0 + bs)
        s = torch.einsum("ed,eds->es", qc, _exact(kt[:, :, blk], cdt))
        if ks is not None:
            s = s * ks[:, blk]
        valid = torch.arange(j0, j0 + bs, device=q.device)[None, :] < lens
        s = torch.where(valid, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        l = l * corr + p.sum(dim=1, keepdim=True)
        m = m_new
        if vs is not None:
            p = p * vs[:, blk]
        acc = acc * corr + torch.einsum("es,esd->ed", _exact(p, cdt),
                                        _exact(v[:, blk], cdt))
    return (acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype)


def _whole_row_probs(q, ks, vs, length, s):
    """The selector and blockdiag forms' softmax: f32 scores s (E, S) ->
    normalized probabilities times vs; a row of length 0 attends uniformly
    (every score NEG)."""
    if ks is not None:
        s = s * ks
    pos = torch.arange(s.shape[1], device=q.device)[None, :]
    s = torch.where(pos < _row_lengths(length, q.shape[0], q.device)[:, None],
                    s, NEG)
    p = torch.softmax(s, dim=-1)
    return p * vs if vs is not None else p


def decode_attention_selector_ref(q, kt, ks, v, vs, length, *,
                                  rows_per_program: int = 8,
                                  v_transposed: bool = False):
    """Plain version of K1-selector (JAX ``_selector_kernel`` :311): each
    score the f32 sum of q * k products rounded to the working dtype (the
    elementwise product before the selector dot); p normalized, times vs,
    rounded to the working dtype and multiplied with v in it, the products
    summed in f32 (:357-359). v is (E, S, dv), or (E, dv, S) with
    ``v_transposed``. ``rows_per_program`` groups rows only."""
    del rows_per_program
    cdt = _compute_dtype(q)
    vt = v if v_transposed else v.transpose(1, 2)
    s = (kt.to(cdt) * q.to(cdt)[:, :, None]).float().sum(dim=1)
    p = _whole_row_probs(q, ks, vs, length, s)
    out = (vt.to(cdt) * p.to(cdt)[:, None, :]).float().sum(dim=2)
    return out.to(q.dtype)


def decode_attention_blockdiag_ref(q, kt, ks, v, vs, length, *,
                                   rows_per_program: Optional[int] = None):
    """Plain version of K1-blockdiag (JAX ``_blockdiag_kernel`` :415): the
    scores as a working-dtype product accumulated in f32, p normalized,
    times vs and cast to the working dtype, the value product accumulated in
    f32 (:449-458). ``rows_per_program`` groups rows only."""
    del rows_per_program
    cdt = _compute_dtype(q)
    s = torch.einsum("ed,eds->es", _exact(q, cdt), _exact(kt, cdt))
    p = _whole_row_probs(q, ks, vs, length, s)
    out = torch.einsum("es,esd->ed", _exact(p, cdt), _exact(v, cdt))
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _gathered_schedule(e: int, dk: int, dv: int, s_len: int, elt: int, sms: int = 132):
    """K1-gathered's launch for E rows of an S-wide cache of ``elt``-byte
    elements on a card of ``sms`` SMs: None where K1's schedule needs no
    split (the rows fill the card: gathered takes K1's launch), else the
    length-balanced one, ``(qpl, warps, stages, grid, ws_floats)``.

    Its CTAs are K1's few-row row groups (``warps`` warps, one row group a
    CTA, csrc/decode_attention.cuh ``Layout``) on a ring of 2 stages, and
    the grid is as many as the card holds at once: ``per_sm`` an SM, at
    most K1's register bound (two CTAs of 8 warps, ``__launch_bounds__(256,
    2)``), fewer where their rings do not fit an SM's shared memory. At
    gpt-generate's decode (~6 tiles a CTA) and at S 16384, 3 stages read
    9% and 5% slower, 1 CTA an SM or 4-warp CTAs slower still
    (``probe_gathered.py``, PERF.md). The kernel splits the rows' valid
    group tiles evenly over the grid; each (CTA, row) piece that is not a
    whole row writes a partial of 4 + round4(dv) f32 to one of grid + E - 1
    slots (``ws_floats`` in all)."""
    qpl, warps, _, split, _ = _k1_schedule(e, dk, dv, s_len, elt, sms)
    if split == 1:
        return None
    group = _k1_group_bytes(qpl, dk, dv, elt, warps, 2) + _SMEM_RESERVED
    per_sm = 16 // warps
    while per_sm > 1 and per_sm * group > _SM_SMEM:
        per_sm -= 1
    grid = sms * per_sm
    return qpl, warps, 2, grid, (grid + e - 1) * (4 + -(-dv // 4) * 4)


# K1-gathered's row tickets: int32 zeros, one buffer a (device, stream),
# grown with E; each launch leaves them 0 again
_TICKETS: dict = {}


def _tickets(e: int, device) -> torch.Tensor:
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < e:
        buf = torch.zeros(max(e, 2 * buf.numel() if buf is not None else 0),
                          dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf


def _gathered_kernel(q, kt, ks, v, vs, length):
    """K1-gathered on the card (csrc/decode_attention_gathered.cu): K1's
    launch with the (m, l) epilogue's empty row where K1 needs no split,
    else the length-balanced launch; one launch either way."""
    e, dk, s_len, dv = _check_operands(q, kt, ks, v, vs, _GATHERED.name)
    sched = _gathered_schedule(e, dk, dv, s_len, kt.element_size(),
                               _build.sm_count(q.device.index))
    if sched is None:
        return _k1_kernel(q, kt, ks, v, vs, length, kernel=_GATHERED, empty_zero=True)
    qpl, warps, stages, grid, ws_floats = sched
    lens, scalar_len = _lengths_arg(length, e, q.device)
    out = torch.empty((e, dv), dtype=q.dtype, device=q.device)
    ws = torch.empty(ws_floats, dtype=torch.float32, device=q.device)
    P = _build.Ptr.of
    code = _build.DTYPE_CODE
    _build.launch(
        _GATHERED, "decode_attention_gathered_launch", P(q), P(kt), P(ks), P(v),
        P(vs), P(lens), P(out), P(ws), P(_tickets(e, q.device)), e, dk, s_len, dv,
        scalar_len, q.stride(0), kt.stride(0), kt.stride(1), v.stride(0),
        v.stride(1), *_scale_strides(ks, vs), code[q.dtype], code[kt.dtype], qpl,
        warps, stages, grid)
    return out


def decode_attention_gathered(q, kt, ks, v, vs, length, *,
                              rows_per_program: int = 8, block_s: int = 128):
    """Length-adaptive decode attention (K1-gathered, JAX :238), K1's
    contract; a row of length 0 returns 0. CPU tensors, and every call
    inside ``_build.plain_path()``, take
    :func:`decode_attention_gathered_ref`; otherwise a CUDA tensor launches
    the kernel (``csrc/decode_attention_gathered.cu``: K1's body, the rows'
    valid tiles split evenly over the card, any S) or raises.
    ``rows_per_program`` and ``block_s`` are JAX's tiling: accepted, and on
    the card they choose nothing (the plain version's f32 sums follow
    ``block_s``'s blocks)."""
    if block_s < 1:
        raise ValueError(f"block_s must be positive, got {block_s}")
    if not q.is_cuda or not _build.kernels_enabled():
        return decode_attention_gathered_ref(q, kt, ks, v, vs, length,
                                             rows_per_program=rows_per_program,
                                             block_s=block_s)
    return _gathered_kernel(q, kt, ks, v, vs, length)


def decode_attention_selector(q, kt, ks, v, vs, length, *,
                              rows_per_program: int = 8,
                              v_transposed: bool = False):
    """Selector decode attention (K1-selector, JAX :365), K1's contract; v
    may come as (E, dv, S) with ``v_transposed``, JAX's production layout
    for this kernel. Dispatch as in :func:`decode_attention_gathered`: the
    kernel (K1's body over the transposed values, any S, any dv) reads them
    in place; with ``v_transposed=False`` the wrapper first makes the
    contiguous transposed copy JAX's ``swapaxes`` makes (:379).
    ``rows_per_program`` is JAX's tiling (rows a program): accepted, not
    used (the kernel takes K1's schedule)."""
    if not q.is_cuda or not _build.kernels_enabled():
        return decode_attention_selector_ref(q, kt, ks, v, vs, length,
                                             rows_per_program=rows_per_program,
                                             v_transposed=v_transposed)
    vt = v if v_transposed else v.transpose(1, 2).contiguous()
    return _k1_kernel(q, kt, ks, vt, vs, length, kernel=_SELECTOR, vt=True)


def decode_attention_blockdiag(q, kt, ks, v, vs, length, *,
                               rows_per_program: Optional[int] = None):
    """Block-diagonal decode attention (K1-blockdiag, JAX :465), K1's
    contract. Dispatch as in :func:`decode_attention_gathered`: the kernel
    is K1's (``csrc/decode_attention.cu``, K1's schedule, any S), counted as
    ``decode_attention_blockdiag``. ``rows_per_program`` is JAX's tiling
    (rows a program, its VMEM rule when None, :475-481): accepted, not
    used."""
    if not q.is_cuda or not _build.kernels_enabled():
        return decode_attention_blockdiag_ref(q, kt, ks, v, vs, length,
                                              rows_per_program=rows_per_program)
    return _k1_kernel(q, kt, ks, v, vs, length, kernel=_BLOCKDIAG)


# ---------------------------------------------------------------- low-bit (K8)
#
# Caches with int4 pair-packed values (ops/quant.py pair packing): packed
# column j holds positions 2j and 2j+1; scales (E, 2, S/2) carry the parity
# on the middle axis. Keys are pair-packed too (``*_int4``) or int8 in the
# even/odd split layout (E, dk, 2, S/2) (``*_mixed``, the Backpack's
# contextualization keys). The even and odd halves are scored apart and
# softmaxed together, so a window of w positions is the first ceil(w/2)
# packed columns.

def _lowbit_ref(q, k_lo, k_hi, ks2, v4, vs2, length, ml=False):
    cdt = _compute_dtype(q)
    E, S2 = q.shape[0], v4.shape[1]
    lengths = _row_lengths(length, E, q.device)
    qc = q.to(cdt)
    s_e = torch.einsum("ed,eds->es", qc, k_lo.to(cdt)).float() * ks2[:, 0]
    s_o = torch.einsum("ed,eds->es", qc, k_hi.to(cdt)).float() * ks2[:, 1]
    j = torch.arange(S2, device=q.device)[None, :]
    v_lo, v_hi = quant.unpack_int4_pairs_split(v4)
    if ml:
        # one segment over both parities: m before any exp, l with that m
        ok = torch.cat([2 * j < lengths[:, None], 2 * j + 1 < lengths[:, None]],
                       dim=1)
        return _segment(torch.cat([s_e, s_o], dim=1), ok,
                        torch.cat([vs2[:, 0], vs2[:, 1]], dim=1),
                        torch.cat([v_lo, v_hi], dim=1), cdt, q.dtype)
    s_e = torch.where(2 * j < lengths[:, None], s_e, NEG)
    s_o = torch.where(2 * j + 1 < lengths[:, None], s_o, NEG)
    p = torch.softmax(torch.cat([s_e, s_o], dim=1), dim=-1)
    p_e = p[:, :S2] * vs2[:, 0]
    p_o = p[:, S2:] * vs2[:, 1]
    out = (torch.einsum("es,esd->ed", p_e.to(cdt), v_lo.to(cdt)).float()
           + torch.einsum("es,esd->ed", p_o.to(cdt), v_hi.to(cdt)).float())
    return out.to(q.dtype)


def decode_attention_flat_int4(q, kt4, ks2, v4, vs2, length):
    """Plain version of K8 over int4 caches (JAX :532): q (E, dk)
    pre-scaled; kt4 (E, dk, S/2) and v4 (E, S/2, dv) pair-packed; ks2, vs2
    (E, 2, S/2) f32. Returns (E, dv) in q's dtype."""
    k_lo, k_hi = quant.unpack_int4_pairs_split(kt4)
    return _lowbit_ref(q, k_lo, k_hi, ks2, v4, vs2, length)


def decode_attention_flat_int4_ml(q, kt4, ks2, v4, vs2, length):
    """Plain version of K8-ml: (out, m, l) of the int4 segment, the Pallas
    ml body's results (:922, epilogue :651-655); JAX's XLA branch of
    ``decode_attention_int4_staged_ml`` (:1211-1239) agrees on every row
    with a valid position (an all-masked row returns (0, NEG, 0))."""
    k_lo, k_hi = quant.unpack_int4_pairs_split(kt4)
    return _lowbit_ref(q, k_lo, k_hi, ks2, v4, vs2, length, ml=True)


def decode_attention_flat_mixed(q, k8, ks2, v4, vs2, length):
    """Plain version of K8 over the mixed cache (JAX :763): k8
    (E, dk, 2, S/2) int8 in the even/odd split layout, the rest as in
    :func:`decode_attention_flat_int4`."""
    return _lowbit_ref(q, k8[:, :, 0], k8[:, :, 1], ks2, v4, vs2, length)


@functools.lru_cache(maxsize=None)
def _k8_schedule(e: int, dk: int, dv: int, s2: int, split_keys: bool, sms: int = 132):
    """K8's launch shape for E rows of S/2 = ``s2`` packed columns on a card
    of ``sms`` SMs: ``(qpl, warps, rows, split, stages)``, over K8's layout
    (a packed column is two positions, one byte a d row of int4 keys, two
    runs of one over the mixed cache's split int8 keys, one byte a value
    channel); a warp takes K1's 32 packed columns of a narrow row, 8 of a
    wide one. The serve's rows are short (64 or 128 packed columns under
    its windows) and a row's work small, so a CTA takes several rows of 2
    warps, which puts more rows on an SM (``probe_k8.py``, PERF.md): 4
    narrow rows, 2 wide ones up to 128 packed columns, 1 wide row of 4
    warps past that. Where such CTAs would leave SMs idle, a CTA takes one
    row, K1's 8 warps (narrow) or 4 (wide), with S split over a cluster
    where even that leaves SMs idle. A ring of 2 stages."""
    if _quads(dv) == 1:
        wr, rows = (2, 4) if -(-e // 4) >= sms else (8, 1)
    else:
        wr, rows = (2, 2) if s2 <= 128 and -(-e // 2) >= sms else (4, 1)
    return _row_schedule(e, dk, dv, s2, 1, sms, wr, rows, kr=2 if split_keys else 1,
                         np_=2, stages=2)


def _lowbit_kernel(q, keys, ks2, v4, vs2, length, split_keys: bool,
                   ml: bool = False, empty_zero: bool = False):
    """K8 (or K8-ml with ``ml``). ``empty_zero``: a row of length 0 gives 0,
    as the Pallas body does, instead of attending uniformly (the (m, l)
    epilogue's output; m and l are dropped). Any S: the kernel streams the
    valid packed prefix with an online softmax."""
    _check_no_grad("lowbit_decode_attention", q, keys, ks2, v4, vs2)
    e, dk = q.shape
    _build.check_cuda_tensor("q", q, _KV_DTYPES.keys(), 2)
    _build.check_cuda_tensor("keys", keys, (torch.int8,), 4 if split_keys else 3)
    _build.check_cuda_tensor("v4", v4, (torch.int8,), 3)
    s2, dv = v4.shape[1], v4.shape[2]
    kshape = (e, dk, 2, s2) if split_keys else (e, dk, s2)
    if keys.shape != kshape or v4.shape[0] != e:
        raise ValueError(f"shapes q {tuple(q.shape)} keys {tuple(keys.shape)} "
                         f"v4 {tuple(v4.shape)} disagree")
    for name, sc in (("ks2", ks2), ("vs2", vs2)):
        _build.check_cuda_tensor(name, sc, (torch.float32,), 3)
        if sc.shape != (e, 2, s2):
            raise ValueError(f"{name} shape {tuple(sc.shape)} != {(e, 2, s2)}")
    if dk > 256 or dv % 16 or dv > 1024:
        raise ValueError(f"lowbit_decode_attention kernel takes dk <= 256, "
                         f"dv % 16 == 0 and dv <= 1024; got dk={dk} dv={dv}")
    lens, scalar_len = _lengths_arg(length, e, q.device)
    out = torch.empty((e, dv), dtype=q.dtype, device=q.device)
    m, l = _ml_outputs(e, q.device) if ml or empty_zero else (None, None)
    if e:
        P = _build.Ptr.of
        _build.launch(
            _K8_ML if ml else _K8[split_keys], "lowbit_decode_attention_launch",
            P(q), P(keys), P(ks2), P(v4), P(vs2), P(lens), P(out), P(m), P(l),
            e, dk, s2, dv, scalar_len, q.stride(0),
            keys.stride(0), keys.stride(1), keys.stride(2) if split_keys else 0,
            ks2.stride(0), ks2.stride(1), v4.stride(0), v4.stride(1),
            vs2.stride(0), vs2.stride(1), _build.DTYPE_CODE[q.dtype],
            int(split_keys),
            *_k8_schedule(e, dk, dv, s2, split_keys, _build.sm_count(q.device.index)))
    return (out, m, l) if ml else out


def decode_attention_int4(q, kt4, ks2, v4, vs2, length):
    """Single-step attention over int4 caches (K8, ``csrc/lowbit_decode_
    attention.cu``; the contract of JAX's dispatcher :745). CPU tensors,
    and every call inside ``_build.plain_path()``, take
    :func:`decode_attention_flat_int4`; otherwise a CUDA tensor launches
    the kernel or raises. Operands may be strided views (a layer of a
    stacked cache, a window slice): the kernel reads them in place."""
    if not q.is_cuda or not _build.kernels_enabled():
        return decode_attention_flat_int4(q, kt4, ks2, v4, vs2, length)
    return _lowbit_kernel(q, kt4, ks2, v4, vs2, length, split_keys=False)


def decode_attention_int4_ml(q, kt4, ks2, v4, vs2, length):
    """K8-ml: (out, m, l) over int4 caches, as
    :func:`decode_attention_flat_int4_ml` (counted as
    ``lowbit_decode_int4_ml``). Dispatch as in :func:`decode_attention_int4`."""
    if not q.is_cuda or not _build.kernels_enabled():
        return decode_attention_flat_int4_ml(q, kt4, ks2, v4, vs2, length)
    return _lowbit_kernel(q, kt4, ks2, v4, vs2, length, split_keys=False,
                          ml=True)


def decode_attention_mixed(q, k8, ks2, v4, vs2, length):
    """Single-step attention over the mixed cache (K8 with split int8
    keys; JAX :859). Dispatch as in :func:`decode_attention_int4`."""
    if not q.is_cuda or not _build.kernels_enabled():
        return decode_attention_flat_mixed(q, k8, ks2, v4, vs2, length)
    return _lowbit_kernel(q, k8, ks2, v4, vs2, length, split_keys=True)


def decode_attention_int4_blockdiag(q, kt4, ks2, v4, vs2, length, *,
                                    rows_per_program: int = 8,
                                    block_s2: Optional[int] = None):
    """JAX's direct Pallas int4 entry (:667): K8 over int4 caches, a row of
    length 0 giving 0 as the Pallas body does (the dispatcher
    :func:`decode_attention_int4` attends uniformly there, as JAX's XLA
    form). Plain version: :func:`decode_attention_flat_int4_ml`'s output.
    ``rows_per_program`` and ``block_s2`` are the TPU's tiling: accepted,
    not used (K8 streams each row's whole valid prefix on its own
    schedule)."""
    del rows_per_program, block_s2
    if not q.is_cuda or not _build.kernels_enabled():
        return decode_attention_flat_int4_ml(q, kt4, ks2, v4, vs2, length)[0]
    return _lowbit_kernel(q, kt4, ks2, v4, vs2, length, split_keys=False,
                          empty_zero=True)


def decode_attention_mixed_blockdiag(q, k8, ks2, v4, vs2, length, *,
                                     rows_per_program: int = 8,
                                     block_s2: Optional[int] = None):
    """JAX's direct Pallas mixed entry (:808): K8 over split int8 keys and
    int4 values, a row of length 0 giving 0. As
    :func:`decode_attention_int4_blockdiag`."""
    del rows_per_program, block_s2
    if not q.is_cuda or not _build.kernels_enabled():
        return _lowbit_ref(q, k8[:, :, 0], k8[:, :, 1], ks2, v4, vs2, length,
                           ml=True)[0]
    return _lowbit_kernel(q, k8, ks2, v4, vs2, length, split_keys=True,
                          empty_zero=True)


def _layer_window(layer, window_cols, k_all, ks_all, v_all, vs_all):
    k, ks, v, vs = k_all[layer], ks_all[layer], v_all[layer], vs_all[layer]
    if window_cols is not None and window_cols < v.shape[1]:
        w = window_cols
        k, ks, v, vs = k[..., :w], ks[..., :w], v[:, :w], vs[..., :w]
    return k, ks, v, vs


def decode_attention_int4_stacked(layer, q, k_all, ks_all, v_all, vs_all,
                                  length, *, window_cols=None):
    """Single-step int4 attention over layer ``layer`` of stacked caches
    (JAX :1010): k_all (L, E, dk, S/2), ks_all/vs_all (L, E, 2, S/2),
    v_all (L, E, S/2, dv); window_cols reads only the first window_cols
    packed columns. The layer and the window are views, never copies.
    Returns ``out`` alone: JAX's entry also returns the cache buffers it
    donates through the kernel, which PyTorch, writing in place, needs not."""
    return decode_attention_int4(
        q, *_layer_window(layer, window_cols, k_all, ks_all, v_all, vs_all),
        length)


def decode_attention_mixed_stacked(layer, q, k_all, ks_all, v_all, vs_all,
                                   length, *, window_cols=None):
    """Mixed variant of :func:`decode_attention_int4_stacked` (JAX :1042):
    k_all (L, E, dk, 2, S/2) split int8 keys."""
    return decode_attention_mixed(
        q, *_layer_window(layer, window_cols, k_all, ks_all, v_all, vs_all),
        length)


def decode_attention_flat_multi(q, kt, ks, v, vs, length):
    """Multi-query cache attention in plain PyTorch: q (E, t, dk) holds t
    new rows per problem whose K/V are already in the cache, row u at
    absolute position length - t + u; row u sees pos < length - (t-1-u).
    Returns (E, t, dv) in q's dtype."""
    cdt = _compute_dtype(q)
    E, t, _ = q.shape
    S = v.shape[1]
    lengths = _row_lengths(length, E, q.device)
    s = torch.einsum("etd,eds->ets", q.to(cdt), kt.to(cdt)).float()
    if ks is not None:
        s = s * ks[:, None, :]
    pos = torch.arange(S, device=q.device)[None, None, :]
    limit = (lengths[:, None, None]
             - (t - 1 - torch.arange(t, device=q.device))[None, :, None])
    s = torch.where(pos < limit, s, NEG)
    p = torch.softmax(s, dim=-1)
    if vs is not None:
        p = p * vs[:, None, :]
    out = torch.einsum("ets,esd->etd", p.to(cdt), v.to(cdt))
    return out.to(q.dtype)


# ---------------------------------------------------------------- staged
#
# The staging-block serving cache (models/gpt.py): decode appends each
# step's keys and values to a C-column block at a scalar pointer and a flush
# merges the block into the main cache every ~C steps. A step attends over
# two segments: the main cache, valid below base_len (the length at the
# last flush), and the staged columns, valid where 0 <= st_pos < length.

def decode_attention_flat_staged(q, kt, ks, v, vs, base_len,
                                 k_st, ks_st, v_st, vs_st, st_pos, length):
    """Plain two-segment decode attention (JAX :1097), one softmax over
    both: main kt (E, dk, W) / v (E, W, dv) with (E, W) scales or None,
    valid where pos < base_len; staged k_st (E, C, dk) / v_st (E, C, dv)
    with (E, C) scales or None, valid where 0 <= st_pos < length. Returns
    (E, dv) in q's dtype."""
    cdt = _compute_dtype(q)
    E = q.shape[0]
    base = _row_lengths(base_len, E, q.device)
    lens = _row_lengths(length, E, q.device)
    s_m = torch.einsum("ed,eds->es", q.to(cdt), kt.to(cdt)).float()
    if ks is not None:
        s_m = s_m * ks
    pos = torch.arange(kt.shape[-1], device=q.device)[None, :]
    s_m = torch.where(pos < base[:, None], s_m, NEG)
    s_s = torch.einsum("ed,ecd->ec", q.to(cdt), k_st.to(cdt)).float()
    if ks_st is not None:
        s_s = s_s * ks_st
    s_s = torch.where((st_pos >= 0) & (st_pos < lens[:, None]), s_s, NEG)
    p = torch.softmax(torch.cat([s_m, s_s], dim=1), dim=-1)
    p_m, p_s = p[:, :s_m.shape[1]], p[:, s_m.shape[1]:]
    if vs is not None:
        p_m = p_m * vs
    if vs_st is not None:
        p_s = p_s * vs_st
    out = (torch.einsum("es,esd->ed", p_m.to(cdt), v.to(cdt)).float()
           + torch.einsum("ec,ecd->ed", p_s.to(cdt), v_st.to(cdt)).float())
    return out.to(q.dtype)


def decode_attention_flat_multi_staged(q, kt, ks, v, vs, base_len,
                                       k_st, ks_st, v_st, vs_st, st_pos,
                                       length):
    """Staged :func:`decode_attention_flat_multi` (JAX :1149): q (E, t, dk)
    rows at positions length - t + u, written to the staging block before
    the call; the main segment is valid below base_len for every row, the
    staged one under the causal limit st_pos < length - (t-1-u). Returns
    (E, t, dv)."""
    cdt = _compute_dtype(q)
    E, t, _ = q.shape
    base = _row_lengths(base_len, E, q.device)
    lens = _row_lengths(length, E, q.device)
    s_m = torch.einsum("etd,eds->ets", q.to(cdt), kt.to(cdt)).float()
    if ks is not None:
        s_m = s_m * ks[:, None, :]
    pos = torch.arange(kt.shape[-1], device=q.device)[None, None, :]
    s_m = torch.where(pos < base[:, None, None], s_m, NEG)
    s_s = torch.einsum("etd,ecd->etc", q.to(cdt), k_st.to(cdt)).float()
    if ks_st is not None:
        s_s = s_s * ks_st[:, None, :]
    limit = (lens[:, None, None]
             - (t - 1 - torch.arange(t, device=q.device))[None, :, None])
    ok = (st_pos[:, None, :] >= 0) & (st_pos[:, None, :] < limit)
    s_s = torch.where(ok, s_s, NEG)
    p = torch.softmax(torch.cat([s_m, s_s], dim=2), dim=-1)
    p_m, p_s = p[:, :, :s_m.shape[2]], p[:, :, s_m.shape[2]:]
    if vs is not None:
        p_m = p_m * vs[:, None, :]
    if vs_st is not None:
        p_s = p_s * vs_st[:, None, :]
    out = (torch.einsum("ets,esd->etd", p_m.to(cdt), v.to(cdt)).float()
           + torch.einsum("etc,ecd->etd", p_s.to(cdt), v_st.to(cdt)).float())
    return out.to(q.dtype)


def stage_segment_attention(q, k_st, ks_st, v_st, vs_st, st_pos, length):
    """(out, m, l) of the stage segment (JAX :1245): k_st/v_st (E, C, d)
    staged columns with (E, C) scales or None; st_pos (E, C) logical
    positions (-1 free, valid below length). Normalized out; an all-masked
    row returns (0, NEG, 0) so that :func:`merge_softmax_segments` weighs
    it out. Plain PyTorch on every device: C <= 64 columns."""
    cdt = _compute_dtype(q)
    lens = _row_lengths(length, q.shape[0], q.device)
    s = torch.einsum("ed,ecd->ec", q.to(cdt), k_st.to(cdt)).float()
    if ks_st is not None:
        s = s * ks_st
    ok = (st_pos >= 0) & (st_pos < lens[:, None])
    return _segment(s, ok, vs_st, v_st, cdt, q.dtype)


def merge_softmax_segments(o1, m1, l1, o2, m2, l2, dtype=None):
    """Flash-style combination of two normalized softmax segments (JAX
    :1270); both empty (a slot just admitted) gives 0."""
    dtype = dtype or o1.dtype
    m = torch.maximum(m1, m2)
    w1 = l1 * torch.exp(m1 - m)
    w2 = l2 * torch.exp(m2 - m)
    tot = torch.clamp_min(w1 + w2, 1e-30)
    return ((o1.float() * w1 + o2.float() * w2) / tot).to(dtype)


def decode_attention_staged(q, kt, ks, v, vs, base_len,
                            k_st, ks_st, v_st, vs_st, st_pos, length):
    """The staged decode step of the port (the contract of
    :func:`decode_attention_flat_staged`): K1's (m, l) form over the main
    segment, read in place below base_len at stored precision, then the
    plain stage segment and the merge. JAX leaves this step to one fused
    XLA contraction; in PyTorch that contraction would materialize the
    dequantized window (at batch 128 and window 256 the Backpack combine
    alone would write ~0.8 GB a step), so the main segment takes the
    kernel, as unstaged decode does."""
    o_m, m_m, l_m = decode_attention_ml(q, kt, ks, v, vs, base_len)
    o_s, m_s, l_s = stage_segment_attention(q, k_st, ks_st, v_st, vs_st,
                                            st_pos, length)
    return merge_softmax_segments(o_m, m_m, l_m, o_s, m_s, l_s)


def decode_attention_int4_staged_ml(layer, q, k_all, ks_all, v_all, vs_all,
                                    base_len, *, window_cols=None):
    """Main-segment attention over layer ``layer`` of the packed int4 caches
    (JAX :1205), valid below base_len: (out, m, l) through K8-ml, the layer
    and the window read in place. Returns no cache buffers: JAX's entry
    donates them through its kernel, PyTorch needs not."""
    return decode_attention_int4_ml(
        q, *_layer_window(layer, window_cols, k_all, ks_all, v_all, vs_all),
        base_len)
