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
``csrc/quant_matmul.cu``), INT8 per-channel included: PyTorch has no
int8-weight x bf16-activation product, and dequantizing first would write a
bf16 copy of every weight to device memory each call.
"""

from __future__ import annotations

import dataclasses
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
    return QuantWeight(q=q, scale=scale, bias=None, bits=bits, d_out=d_out)


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

def quant_matmul_ref(x: torch.Tensor, qw: QuantWeight) -> torch.Tensor:
    """Plain version of K2: dequantize to x's dtype, then one product in
    that dtype (f32 accumulation inside the product)."""
    return x @ dequantize_weight(qw, x.dtype)


def quant_matmul(x: torch.Tensor, qw: QuantWeight) -> torch.Tensor:
    """x (..., in) @ dequant(qw) -> (..., d_out), dequantization fused into
    the GEMM (K2). CPU tensors, and every call inside
    ``_build.plain_path()``, take :func:`quant_matmul_ref`; otherwise a
    CUDA tensor launches the kernel, which takes bf16 x, int8/int4 weights
    with (groups, out) f32 scales and emits bf16, or raises."""
    if not x.is_cuda or not _build.kernels_enabled():
        return quant_matmul_ref(x, qw)
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
    x2 = x.reshape(-1, d_in).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, qw.d_out), dtype=torch.bfloat16, device=x.device)
    if m:
        P = _build.Ptr.of
        _build.launch(_K2, "quant_matmul_launch", P(x2), P(qw.q), P(qw.scale),
                      P(out), m, d_in, n_pad, qw.d_out, groups, qw.bits)
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
    """Quantized analogue of dense.linear: :func:`quant_matmul`, then the
    bias in f32."""
    y = quant_matmul(x, qp)
    if qp.bias is not None:
        y = (y.float() + qp.bias.float()).to(y.dtype)
    return y


# ---------------------------------------------------------------- activations

def quantize_activations_int8(x: torch.Tensor, axis: int = -1):
    """Dynamic per-row INT8 quantization (INT8 caches). Returns (q, scale)
    with x ~= q * scale; scale keeps the reduced axis (size 1)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(absmax / 127.0, 1e-10)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale

