"""Dense (linear) layers and activations.

Port of ``backpacks_flash_attn_tpu/ops/dense.py``. Kernels are stored
``(in, out)`` as in the JAX tree, so ``x @ kernel`` needs no transpose and
the tests compare weights element by element. A quantized weight
(:class:`~.quant.QuantWeight`) dispatches to ``quant.quant_linear`` and
through it to the dequant GEMM kernel on the card.

:func:`mlp` on fp weights is JAX's ``_mlp_fused`` custom VJP (:88-161): the
forward saves only x and the pre-activation, and the backward recomputes
the activation and its derivative from it. With ``BACKPACKS_FUSED_MLP=1``
its forward is the fused kernel K7 (``ops/fused_mlp.py``) where
``fused_mlp.supported`` holds.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

# The single-pass MLP forward (K7), off unless BACKPACKS_FUSED_MLP=1, read
# as JAX reads it (dense.py:27); a module attribute that callers may set.
_FUSED_MLP = os.environ.get("BACKPACKS_FUSED_MLP", "0") == "1"


def gelu(x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    """GELU; approximate=True is the tanh form ('gelu_new')."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


ACTIVATIONS = {
    "gelu": lambda x: gelu(x, approximate=False),
    "gelu_new": lambda x: gelu(x, approximate=True),
    "gelu_fast": lambda x: gelu(x, approximate=True),
    "relu": F.relu,
    "sqrelu": lambda x: F.relu(x).square(),
}


def linear(x: torch.Tensor, params) -> torch.Tensor:
    """x @ kernel + bias. bf16 x bf16 products emit bf16 and add the bias in
    bf16 (as the JAX path does); other dtypes accumulate in f32 and cast
    back to x's dtype."""
    from . import quant
    if quant.is_quantized(params):
        return quant.quant_linear(x, params)
    kernel = params["kernel"]
    bias = params.get("bias")
    if x.dtype == torch.bfloat16 and kernel.dtype == torch.bfloat16:
        y = x @ kernel
        return y + bias.to(y.dtype) if bias is not None else y
    y = x.float() @ kernel.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _mlp_fwd_math(x, params, activation):
    """-> (out, h_pre): K7 when the switch is on and the weights qualify,
    else the two linears around the activation (JAX :88)."""
    from . import fused_mlp
    if _FUSED_MLP and fused_mlp.supported(params, activation):
        return fused_mlp.mlp_fwd_fused(
            x, params["fc1"]["kernel"], params["fc1"]["bias"],
            params["fc2"]["kernel"], params["fc2"]["bias"],
            activation=activation)
    h_pre = linear(x, params["fc1"])
    return linear(ACTIVATIONS[activation](h_pre), params["fc2"]), h_pre


def _dot(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """a @ b accumulated in f32 and rounded to dtype (bf16 operands and
    result: one bf16 product, which rounds its f32 sum once)."""
    if a.dtype == b.dtype == dtype == torch.bfloat16:
        return a @ b
    return (a.float() @ b.float()).to(dtype)


class _MLP(torch.autograd.Function):
    """fc1 -> act -> fc2 with JAX ``_mlp_fused``'s residuals (x, h_pre) and
    backward (``_mlp_fused_bwd`` :116): the activation and its derivative
    recomputed from h_pre, the dgrad products in x's dtype (bf16 products
    emit bf16), the weight and bias gradients summed in f32."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, activation):
        params = {"fc1": {"kernel": w1}, "fc2": {"kernel": w2}}
        if b1 is not None:
            params["fc1"]["bias"] = b1
        if b2 is not None:
            params["fc2"]["bias"] = b2
        out, h_pre = _mlp_fwd_math(x, params, activation)
        ctx.save_for_backward(x, h_pre, w1, w2)
        ctx.activation = activation
        ctx.bias_dtypes = (None if b1 is None else b1.dtype,
                           None if b2 is None else b2.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        x, h_pre, w1, w2 = ctx.saved_tensors
        with torch.enable_grad():
            hp = h_pre.detach().requires_grad_()
            a = ACTIVATIONS[ctx.activation](hp)
        g = g.to(x.dtype)
        da = _dot(g, w2.T, x.dtype)
        dh, = torch.autograd.grad(a, hp, da)
        xm, am, gm, dhm = (t.reshape(-1, t.shape[-1]) for t in (x, a, g, dh))
        dw1 = _dot(xm.T, dhm, w1.dtype)
        dw2 = _dot(am.detach().T, gm, w2.dtype)
        db1_dt, db2_dt = ctx.bias_dtypes
        db1 = None if db1_dt is None else dhm.float().sum(0).to(db1_dt)
        db2 = None if db2_dt is None else gm.float().sum(0).to(db2_dt)
        dx = _dot(dh, w1.T, x.dtype)
        return dx, dw1, db1, dw2, db2, None


def mlp(x: torch.Tensor, params: dict, activation: str = "gelu_new") -> torch.Tensor:
    """fc1 -> act -> fc2 (JAX :164): quantized weights through the linear
    pair, fp weights through :class:`_MLP`."""
    from . import quant
    if quant.is_quantized(params["fc1"]) or quant.is_quantized(params["fc2"]):
        act = ACTIVATIONS[activation]
        return linear(act(linear(x, params["fc1"])), params["fc2"])
    return _MLP.apply(x, params["fc1"]["kernel"], params["fc1"].get("bias"),
                      params["fc2"]["kernel"], params["fc2"].get("bias"),
                      activation)


def _normal(generator: torch.Generator, shape, std: float, dtype,
            device) -> torch.Tensor:
    """N(0, std^2) drawn on the generator's device, then moved."""
    w = torch.randn(shape, generator=generator, device=generator.device)
    return (w * std).to(device=device, dtype=dtype)


def init_linear(generator: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = True, std: float = 0.02, dtype=torch.float32,
                device="cuda") -> dict:
    p = {"kernel": _normal(generator, (d_in, d_out), std, dtype, device)}
    if bias:
        p["bias"] = torch.zeros(d_out, dtype=dtype, device=device)
    return p


def init_mlp(generator: torch.Generator, d_in: int, d_hidden: int,
             d_out: Optional[int] = None, *, std: float = 0.02,
             out_std: Optional[float] = None, dtype=torch.float32,
             device="cuda") -> dict:
    d_out = d_out if d_out is not None else d_in
    return {
        "fc1": init_linear(generator, d_in, d_hidden, std=std, dtype=dtype,
                           device=device),
        "fc2": init_linear(generator, d_hidden, d_out,
                           std=out_std if out_std is not None else std,
                           dtype=dtype, device=device),
    }
