"""Single-query decode attention over (possibly INT8) caches (kernel K1).

Port of ``backpacks_flash_attn_tpu/ops/decode_attention.py``: the contract
of ``decode_attention_fused`` (:77), ``decode_attention_ref`` (:117) and
``decode_attention_flat`` (:134), plus ``decode_attention_flat_multi``
(:1065) in plain PyTorch. Shapes (E = batch * heads, one problem per row):

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

from typing import Optional

import torch

from . import _build

NEG = -1e30
_K1 = _build.KERNELS["decode_attention"]
_KV_DTYPES = {torch.bfloat16: (torch.int8, torch.bfloat16),
              torch.float32: (torch.int8, torch.float32)}


def _row_lengths(length, e: int, device) -> torch.Tensor:
    if isinstance(length, int):
        return torch.full((e,), length, dtype=torch.int64, device=device)
    return torch.as_tensor(length, device=device).reshape(-1).expand(e)


def _compute_dtype(q: torch.Tensor):
    return torch.float32 if q.dtype == torch.float32 else torch.bfloat16


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


def decode_attention(q: torch.Tensor, kt: torch.Tensor,
                     ks: Optional[torch.Tensor], v: torch.Tensor,
                     vs: Optional[torch.Tensor], length) -> torch.Tensor:
    """Single-step cache attention (K1, ``csrc/decode_attention.cu``). CPU
    tensors, and every call inside ``_build.plain_path()``, take
    :func:`decode_attention_ref`; otherwise a CUDA tensor launches the
    kernel or raises."""
    if not q.is_cuda or not _build.kernels_enabled():
        return decode_attention_ref(q, kt, ks, v, vs, length)
    e, dk = q.shape
    _build.check_cuda_tensor("q", q, _KV_DTYPES.keys(), 2)
    _build.check_cuda_tensor("kt", kt, _KV_DTYPES[q.dtype], 3)
    _build.check_cuda_tensor("v", v, (kt.dtype,), 3)
    s_len, dv = v.shape[1], v.shape[2]
    if kt.shape != (e, dk, s_len) or v.shape[0] != e:
        raise ValueError(f"shapes q {tuple(q.shape)} kt {tuple(kt.shape)} "
                         f"v {tuple(v.shape)} disagree")
    for name, sc in (("ks", ks), ("vs", vs)):
        if sc is not None:
            _build.check_cuda_tensor(name, sc, (torch.float32,), 2)
            if sc.shape != (e, s_len):
                raise ValueError(f"{name} shape {tuple(sc.shape)} != "
                                 f"{(e, s_len)}")
    if dk > 256 or dv % 4 or dv > 1024 or s_len > 8192:
        raise ValueError(f"decode_attention kernel takes dk <= 256, "
                         f"dv % 4 == 0 and dv <= 1024, S <= 8192; got "
                         f"dk={dk} dv={dv} S={s_len}")
    vec_bytes = 4 * v.element_size()
    if (v.data_ptr() % vec_bytes or v.stride(0) % 4 or v.stride(1) % 4):
        raise ValueError("decode_attention kernel needs 4-element aligned "
                         "value rows")
    lens_ptr, scalar_len = _build.Ptr.of(None), 0
    if isinstance(length, int):
        scalar_len = length
    else:
        lens = torch.as_tensor(length, device=q.device).to(torch.int32)
        lens = lens.reshape(-1).expand(e).contiguous()
        lens_ptr = _build.Ptr.of(lens)
    out = torch.empty((e, dv), dtype=q.dtype, device=q.device)
    P = _build.Ptr.of
    code = _build.DTYPE_CODE
    _build.launch(
        _K1, "decode_attention_launch", P(q), P(kt), P(ks), P(v), P(vs),
        lens_ptr, P(out), e, dk, s_len, dv, scalar_len,
        q.stride(0), kt.stride(0), kt.stride(1), v.stride(0), v.stride(1),
        ks.stride(0) if ks is not None else 0,
        vs.stride(0) if vs is not None else 0,
        code[q.dtype], code[kt.dtype])
    return out


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
