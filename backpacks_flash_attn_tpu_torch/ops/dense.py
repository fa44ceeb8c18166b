"""Dense (linear) layers and activations.

Port of ``backpacks_flash_attn_tpu/ops/dense.py``. Kernels are stored
``(in, out)`` as in the JAX tree, so ``x @ kernel`` needs no transpose and
the tests compare weights element by element. A quantized weight
(:class:`~.quant.QuantWeight`) dispatches to ``quant.quant_linear`` and
through it to the dequant GEMM kernel on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


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


def mlp(x: torch.Tensor, params: dict, activation: str = "gelu_new") -> torch.Tensor:
    """fc1 -> act -> fc2."""
    act = ACTIVATIONS[activation]
    return linear(act(linear(x, params["fc1"])), params["fc2"])


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
