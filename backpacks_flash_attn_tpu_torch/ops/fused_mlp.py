"""Fused MLP forward (kernel K7): x @ W1 + b1 -> act -> @ W2 + b2.

Port of ``backpacks_flash_attn_tpu/ops/fused_mlp.py`` (``mlp_fwd_fused``
:81 -> ``_mlp_fwd_kernel`` :51, ``supported`` :137). Returns ``(out,
h_pre)``: the pre-activation is rounded to x's dtype and the activation is
applied to that rounded value (JAX :65-70), which is what the backward of
``ops/dense.py`` recomputes from. On the card the forward is
``csrc/fused_mlp.cu``: two GEMM passes split at h_pre, the activation
passed between them through a transient (T, inner) buffer that lives for
the call only.
"""

from __future__ import annotations

import torch

from . import _build
from .dense import ACTIVATIONS

_K7 = _build.KERNELS["fused_mlp_fwd"]

# activation codes shared with csrc/fused_mlp.cu
ACT_CODE = {"gelu": 0, "gelu_new": 1, "gelu_fast": 1, "relu": 2, "sqrelu": 3}


def mlp_fwd_fused_ref(x, w1, b1, w2, b2, *, activation: str = "gelu_new"):
    """Plain version of K7: both products accumulated in f32, bias added in
    f32, h_pre rounded to x's dtype, the activation applied to it in f32
    and rounded to x's dtype again (the kernel's product operand), the out
    rounded once after its bias."""
    d_in = x.shape[-1]
    xm = x.reshape(-1, d_in)
    h = xm.float() @ w1.float() + b1.float()
    hp = h.to(x.dtype)
    a = ACTIVATIONS[activation](hp.float()).to(x.dtype)
    out = (a.float() @ w2.float() + b2.float()).to(x.dtype)
    lead = x.shape[:-1]
    return out.reshape(*lead, w2.shape[1]), hp.reshape(*lead, w1.shape[1])


def _mlp_fwd_kernel(x, w1, b1, w2, b2, *, activation):
    """K7 (``csrc/fused_mlp.cu``): bf16 on tensor cores or f32 SIMT, all
    operands one dtype, every dim a multiple of 128. The activated operand
    of pass 2 goes through a scratch buffer freed when the call returns."""
    d_in, inner = w1.shape
    d_out = w2.shape[1]
    xm = x.reshape(-1, d_in)
    dt = xm.dtype
    for name, t in (("x", xm), ("w1", w1), ("w2", w2)):
        _build.check_cuda_tensor(name, t, (torch.bfloat16, torch.float32), 2)
        if t.dtype != dt:
            raise ValueError(f"{name}: dtype {t.dtype} != x's {dt}")
    if w2.shape[0] != inner or b1.shape != (inner,) or b2.shape != (d_out,):
        raise ValueError(f"shapes w1 {tuple(w1.shape)} b1 {tuple(b1.shape)} "
                         f"w2 {tuple(w2.shape)} b2 {tuple(b2.shape)} disagree")
    if d_in % 128 or inner % 128 or d_out % 128:
        raise ValueError(f"the fused MLP kernel takes dims that are multiples "
                         f"of 128, got {d_in} -> {inner} -> {d_out}")
    if activation not in ACT_CODE:
        raise ValueError(f"activation {activation!r} not in {list(ACT_CODE)}")
    xm, w1, w2 = (t if _build.aligned16(t) and t.is_contiguous()
                  else t.contiguous() for t in (xm, w1, w2))
    b1, b2 = b1.to(dt).contiguous(), b2.to(dt).contiguous()
    T = xm.shape[0]
    out = torch.empty((T, d_out), dtype=dt, device=xm.device)
    hpre = torch.empty((T, inner), dtype=dt, device=xm.device)
    act = torch.empty((T, inner), dtype=dt, device=xm.device)
    P = _build.Ptr.of
    _build.launch(_K7, "fused_mlp_fwd_launch", P(xm), P(w1), P(b1), P(w2),
                  P(b2), P(out), P(hpre), P(act), T, d_in, inner, d_out,
                  ACT_CODE[activation], _build.DTYPE_CODE[dt])
    lead = x.shape[:-1]
    return out.reshape(*lead, d_out), hpre.reshape(*lead, inner)


def mlp_fwd_fused(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor, *,
                  activation: str = "gelu_new"):
    """-> (out (..., d_out), h_pre (..., inner)) in x's dtype. CPU tensors,
    and every call inside ``_build.plain_path()``, take
    :func:`mlp_fwd_fused_ref`; otherwise a CUDA tensor launches K7 or
    raises."""
    fn = (_mlp_fwd_kernel if x.is_cuda and _build.kernels_enabled()
          else mlp_fwd_fused_ref)
    return fn(x, w1, b1, w2, b2, activation=activation)


def supported(params, activation: str) -> bool:
    """Static eligibility (JAX :137): bias-ful fp kernels with 128-aligned
    dims, and no wide-output projection (the Backpack content net's 768 ->
    3072 -> 12288 sense projection, whose output must reach device memory
    whole anyway)."""
    try:   # a quantized linear is a QuantWeight, which takes no key
        w1, w2 = params["fc1"]["kernel"], params["fc2"]["kernel"]
    except (KeyError, TypeError):
        return False
    if "bias" not in params["fc1"] or "bias" not in params["fc2"]:
        return False
    if activation not in ACT_CODE:
        return False
    d_in, inner = w1.shape
    d_out = w2.shape[1]
    if d_out > max(2048, d_in):
        return False
    return (d_in % 128 == 0 and inner % 128 == 0 and d_out % 128 == 0
            and inner % min(512, inner) == 0)
