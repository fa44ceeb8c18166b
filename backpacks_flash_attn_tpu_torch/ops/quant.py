"""Weight-only INT8/INT4 quantization and the dequant GEMM (kernel K2).

Port of ``backpacks_flash_attn_tpu/ops/quant.py``. Layouts are the JAX
package's:

* a quantized linear is a :class:`QuantWeight`: ``q`` int8 ``(in, out)``
  (INT4: ``(in/2, out)``, two consecutive ``in`` rows per byte, low nibble =
  even row), ``scale`` f32 ``(groups, out)``, optional ``bias``; ``out`` is
  zero-padded to a multiple of 128 and ``d_out`` is the logical width.
  Stacked layers carry a leading ``(n_layer,)`` axis on ``q``/``scale``.
* symmetric scales, round-half-to-even (``torch.round``), the same f32
  operation order as JAX (``wf / scale``), so ``q`` is bit-identical.

On the card every ``QuantWeight`` goes through :func:`quant_matmul` (K2,
``csrc/quant_matmul.cu``), INT8 per-channel included, with the linear's
bias added in the kernel's epilogue: PyTorch has no int8-weight x
bf16-activation product, and dequantizing first would write a bf16 copy of
every weight to device memory each call. :func:`_k2_schedule` picks the
kernel's tile width and K split for each shape.

The activation quantizers and the int4 pair packing of the low-bit decode
caches (``quantize_activations_int4``, ``pack_int4_pairs``, ``rmw_nibble``
...) keep the JAX package's byte convention bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from . import _build

_K2 = _build.KERNELS["quant_matmul"]


@dataclasses.dataclass
class QuantWeight:
    """Quantized (in, out) kernel. q: int8 (..., in, out) [int4: (..., in/2,
    out) packed]; scale: f32 (..., groups, out); d_out: logical out width."""
    q: torch.Tensor
    scale: torch.Tensor
    bias: Optional[torch.Tensor]
    bits: int
    d_out: int


@dataclasses.dataclass
class QuantTable:
    """Quantized gather table (the (V, nv, d) sense table): q int8
    (V, ..., d[/2]); scale f32 (V, ..., 1) per-row scales (or (V, ..., d/g))."""
    q: torch.Tensor
    scale: torch.Tensor
    bits: int


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------- quantize

def quantize_weight(w: torch.Tensor, bits: int = 8,
                    group_size: Optional[int] = None) -> QuantWeight:
    """Symmetric weight-only quantization of an (..., in, out) kernel;
    scale (..., in/group_size, out). out is zero-padded to a multiple of
    128."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    *lead, d_in, d_out = w.shape
    pad_out = _round_up(d_out, 128) - d_out
    if pad_out:
        w = torch.nn.functional.pad(w, (0, pad_out))
    gs = group_size if group_size is not None else d_in
    if d_in % gs:
        raise ValueError(f"group_size {gs} does not divide in={d_in}")
    n = d_out + pad_out
    wf = w.float().reshape(*lead, d_in // gs, gs, n)
    qmax = 127.0 if bits == 8 else 7.0
    absmax = wf.abs().amax(dim=-2)                            # (..., groups, out)
    scale = torch.clamp_min(absmax / qmax, 1e-10)
    q = torch.clamp(torch.round(wf / scale.unsqueeze(-2)), -qmax, qmax)
    q = q.reshape(*lead, d_in, n).to(torch.int8)
    if bits == 4:
        q = pack_int4(q)
    # contiguous, as K2 reads them: a transposed w (the tied head, wte.T)
    # with no out padding would leave both in its strides
    return QuantWeight(q=q.contiguous(), scale=scale.contiguous(), bias=None,
                       bits=bits, d_out=d_out)


def _to_int8_bytes(packed: torch.Tensor) -> torch.Tensor:
    return torch.where(packed >= 128, packed - 256, packed).to(torch.int8)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-8, 7] pairwise along the in axis (-2)."""
    lo = q[..., 0::2, :].to(torch.int32) & 0xF
    hi = (q[..., 1::2, :].to(torch.int32) & 0xF) << 4
    return _to_int8_bytes(lo | hi)


def _sign_extend4(u: torch.Tensor) -> torch.Tensor:
    return torch.where(u >= 8, u - 16, u)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4: (..., in/2, out) -> (..., in, out) in [-8, 7]."""
    u = packed.to(torch.int32) & 0xFF
    lo = _sign_extend4(u & 0xF)
    hi = _sign_extend4((u >> 4) & 0xF)
    *lead, d2, n = packed.shape
    return torch.stack([lo, hi], dim=-2).reshape(*lead, 2 * d2, n).to(torch.int8)


def pack_int4_last(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-8, 7] pairwise along the LAST axis."""
    lo = q[..., 0::2].to(torch.int32) & 0xF
    hi = (q[..., 1::2].to(torch.int32) & 0xF) << 4
    return _to_int8_bytes(lo | hi)


def unpack_int4_last(packed: torch.Tensor) -> torch.Tensor:
    u = packed.to(torch.int32) & 0xFF
    lo = _sign_extend4(u & 0xF)
    hi = _sign_extend4((u >> 4) & 0xF)
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], 2 * packed.shape[-1]).to(torch.int8)


def dequantize_weight(qw: QuantWeight, dtype=torch.bfloat16) -> torch.Tensor:
    q = unpack_int4(qw.q) if qw.bits == 4 else qw.q
    *lead, d_in, d_pad = q.shape
    groups = qw.scale.shape[-2]
    wf = (q.float().reshape(*lead, groups, d_in // groups, d_pad)
          * qw.scale.unsqueeze(-2))
    return wf.reshape(*lead, d_in, d_pad)[..., :qw.d_out].to(dtype)


# ---------------------------------------------------------------- kernel K2

# BK and kMaxSplits in csrc/quant_matmul.cu: the ring's slice of K rows (a
# split chunk's unit) and the largest split (one thread-block cluster); its
# C entry rejects a schedule that breaks either
_K2_SLICE = 64
_K2_MAX_SPLITS = 8
_K2_SMS = 132       # the H100's SMs: the schedule's default without a device


@functools.lru_cache(maxsize=None)
def _k2_schedule(M: int, K: int, N: int, sms: int = _K2_SMS):
    """K2's launch shape for x (M, K) @ (K, N), N a multiple of 128, on a
    card of ``sms`` SMs: ``(bn, splits, chunk)``.

    A CTA takes 128 rows (all of them at decode's M = 128, so each weight
    byte leaves device memory once) and ``bn`` columns: 128 where those
    tiles alone fill the card (the lm-head, every prefill), else 64, or 32
    where 64-column slabs cannot make a full wave in 8 chunks. When the tiles
    number fewer than the card's SMs, K is cut into ``splits`` chunks of
    ``chunk`` rows (whole 64-row slices; the last chunk may be shorter,
    down to 32 rows) so that the CTAs make a full wave; a chunk's f32
    partial goes to a workspace and the chunks of a tile, one cluster, sum
    it in chunk order. The weight format does not change the shape: the
    ring's slice is 64 K rows for int8 and INT4 alike."""
    m_tiles = -(-M // 128)
    slices = -(-K // _K2_SLICE)
    if (N // 128) * m_tiles >= sms:
        return 128, 1, slices * _K2_SLICE
    for bn in (64, 32):
        want = -(-sms // (m_tiles * N // bn))
        per_chunk = max(1, slices // want, -(-slices // _K2_MAX_SPLITS))
        if m_tiles * (N // bn) * -(-slices // per_chunk) >= sms:
            break
    chunk = per_chunk * _K2_SLICE
    return bn, -(-K // chunk), chunk


def quant_matmul_ref(x: torch.Tensor, qw: QuantWeight) -> torch.Tensor:
    """Plain version of K2: dequantize to x's dtype, then one product in
    that dtype (f32 accumulation inside the product)."""
    return x @ dequantize_weight(qw, x.dtype)


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The bias in f32 on the rounded product, rounded again (JAX's
    quant_linear)."""
    if bias is None:
        return y
    return (y.float() + bias.float()).to(y.dtype)


def quant_matmul(x: torch.Tensor, qw: QuantWeight,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., in) @ dequant(qw) [+ bias] -> (..., d_out), dequantization
    fused into the GEMM (K2). CPU tensors, and every call inside
    ``_build.plain_path()``, take :func:`quant_matmul_ref` and add the bias
    eagerly; otherwise a CUDA tensor launches the kernel, which takes bf16
    x, int8/int4 weights with (groups, out) f32 scales and an f32 or bf16
    bias of d_out values, and emits bf16, or raises. The kernel adds the
    bias in its epilogue exactly as the eager add does (round, add in f32,
    round). A split schedule (:func:`_k2_schedule`) allocates its f32
    partials here; the call still counts one launch."""
    if not x.is_cuda or not _build.kernels_enabled():
        return _add_bias(quant_matmul_ref(x, qw), bias)
    d_in = x.shape[-1]
    _build.check_cuda_tensor("x", x, (torch.bfloat16,), x.dim())
    _build.check_cuda_tensor("q", qw.q, (torch.int8,), 2)
    _build.check_cuda_tensor("scale", qw.scale, (torch.float32,), 2)
    if qw.bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {qw.bits}")
    n_pad = qw.q.shape[1]
    groups = qw.scale.shape[0]
    pack = 2 if qw.bits == 4 else 1
    if (qw.q.shape[0] * pack != d_in or qw.scale.shape[1] != n_pad
            or not qw.q.is_contiguous() or not qw.scale.is_contiguous()):
        raise ValueError(f"weight shapes q {tuple(qw.q.shape)} scale "
                         f"{tuple(qw.scale.shape)} do not fit in={d_in}")
    if d_in % 32 or n_pad % 128 or d_in % groups or qw.d_out > n_pad:
        raise ValueError(f"quant_matmul kernel needs in % 32 == 0 and a "
                         f"128-padded out, got in={d_in} out={n_pad}")
    if bias is not None:
        _build.check_cuda_tensor("bias", bias, (torch.float32, torch.bfloat16), 1)
        if bias.shape[0] != qw.d_out:
            raise ValueError(f"bias of {bias.shape[0]} values for d_out={qw.d_out}")
    x2 = x.reshape(-1, d_in).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, qw.d_out), dtype=torch.bfloat16, device=x.device)
    if m:
        bn, splits, chunk = _k2_schedule(m, d_in, n_pad, _build.sm_count(x.device.index))
        ws = (torch.empty((splits, m, n_pad), dtype=torch.float32, device=x.device)
              if splits > 1 else None)
        P = _build.Ptr.of
        _build.launch(_K2, "quant_matmul_launch", P(x2), P(qw.q), P(qw.scale),
                      P(bias), _build.DTYPE_CODE[bias.dtype] if bias is not None else 0,
                      P(out), P(ws), m, d_in, n_pad, qw.d_out, groups, qw.bits,
                      bn, splits, chunk)
    return out.reshape(*x.shape[:-1], qw.d_out)


# ---------------------------------------------------------------- linear API

def quantize_linear_params(p: dict, bits: int = 8,
                           group_size: Optional[int] = None) -> QuantWeight:
    """Quantize a dense.linear param dict {'kernel', 'bias'?}."""
    qp = quantize_weight(p["kernel"], bits, group_size)
    return dataclasses.replace(qp, bias=p.get("bias"))


def is_quantized(p) -> bool:
    return isinstance(p, QuantWeight)


def quant_linear(x: torch.Tensor, qp: QuantWeight) -> torch.Tensor:
    """Quantized analogue of dense.linear: :func:`quant_matmul` with the
    bias in f32 on the rounded product (in K2's epilogue on the card,
    eagerly on the plain path)."""
    return quant_matmul(x, qp, bias=qp.bias)


# ---------------------------------------------------------------- activations

def quantize_activations_int8(x: torch.Tensor, axis: int = -1):
    """Dynamic per-row INT8 quantization (INT8 caches). Returns (q, scale)
    with x ~= q * scale; scale keeps the reduced axis (size 1)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(absmax / 127.0, 1e-10)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_activations_int4(x: torch.Tensor, axis: int = -1):
    """Dynamic per-row INT4 quantization (the int4 caches): q int8 nibble
    values in [-7, 7], not yet packed (pair packing along the position axis
    is the cache layout), and scale with the reduced axis kept."""
    xf = x.float()
    absmax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(absmax / 7.0, 1e-10)
    q = torch.clamp(torch.round(xf / scale), -7, 7).to(torch.int8)
    return q, scale


# ------------------------------------------------------- int4 pair packing
#
# The decode caches' convention: packed column j holds position 2j in the
# LOW nibble and 2j+1 in the HIGH nibble. Readers never interleave: the
# decode attention scores the even and odd halves separately and softmaxes
# them jointly, so a window of w positions is the first ceil(w/2) columns.
# Scales ride as (..., 2, S/2): parity on the second-to-last axis.

def _every_other(q: torch.Tensor, axis: int, start: int) -> torch.Tensor:
    idx = [slice(None)] * q.dim()
    idx[axis] = slice(start, None, 2)
    return q[tuple(idx)]


def pack_int4_pairs(q: torch.Tensor, axis: int) -> torch.Tensor:
    """Pack nibble values in [-8, 7] pairwise along ``axis`` (even length):
    out[.., j, ..] = (q[.., 2j+1, ..] << 4) | (q[.., 2j, ..] & 0xF)."""
    if q.shape[axis] % 2:
        raise ValueError(f"axis {axis} of {tuple(q.shape)} has odd length")
    lo = _every_other(q, axis, 0).to(torch.int32) & 0xF
    hi = (_every_other(q, axis, 1).to(torch.int32) & 0xF) << 4
    return _to_int8_bytes(lo | hi)


def unpack_int4_pairs_split(p4: torch.Tensor):
    """(lo, hi) sign-extended nibble values, not interleaved: the even and
    odd position halves the decode attention reads."""
    u = p4.to(torch.int32) & 0xFF
    lo = _sign_extend4(u & 0xF)
    hi = _sign_extend4(u >> 4)
    return lo.to(torch.int8), hi.to(torch.int8)


def unpack_int4_pairs(p4: torch.Tensor, axis: int) -> torch.Tensor:
    """Interleaved unpack along ``axis`` (the prefill's dequantization):
    the inverse of :func:`pack_int4_pairs`."""
    axis = axis % p4.dim()
    lo, hi = unpack_int4_pairs_split(p4)
    shape = list(p4.shape)
    shape[axis] *= 2
    return torch.stack([lo, hi], dim=axis + 1).reshape(shape)


def interleave_pair_scales(sc2: torch.Tensor) -> torch.Tensor:
    """(..., 2, n) per-(parity, packed column) scales -> (..., 2n)
    per-position scales."""
    if sc2.shape[-2] != 2:
        raise ValueError(f"expected a parity axis of 2, got {tuple(sc2.shape)}")
    return sc2.transpose(-1, -2).reshape(*sc2.shape[:-2], 2 * sc2.shape[-1])


def rmw_nibble(old: torch.Tensor, nib: torch.Tensor, parity) -> torch.Tensor:
    """Replace one nibble of packed bytes: parity 0 -> low, 1 -> high
    (``parity`` an int or a tensor broadcasting against ``old``). A decode
    step's write is this read-modify-write of one packed column."""
    o = old.to(torch.int32)
    n = nib.to(torch.int32) & 0xF
    even = (o & -16) | n            # -16 == ~0xF
    odd = (o & 0xF) | (n << 4)
    par = torch.as_tensor(parity, device=old.device)
    return _to_int8_bytes(torch.where(par == 0, even, odd) & 0xFF)

