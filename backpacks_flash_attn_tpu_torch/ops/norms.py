"""LayerNorm and dropout+add+LayerNorm (inference: dropout 0).

Port of ``backpacks_flash_attn_tpu/ops/norms.py`` (``layer_norm`` :26,
``dropout_add_layer_norm`` :178). Statistics are f32 whatever the input
dtype; the residual stream is carried in f32 and the normalized output keeps
the input dtype. Dropout sites arrive with the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5, out_dtype=None) -> torch.Tensor:
    """LayerNorm with f32 statistics regardless of input dtype."""
    out_dtype = out_dtype if out_dtype is not None else x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(out_dtype)


def dropout_add_layer_norm(
    x: torch.Tensor,
    residual: Optional[torch.Tensor],
    weight: torch.Tensor,
    bias: torch.Tensor,
    dropout_p: float = 0.0,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x + residual -> LayerNorm, the prenorm form. Returns (normalized in
    x's dtype, new_residual in f32)."""
    if dropout_p != 0.0:
        raise NotImplementedError("dropout comes with the training slice")
    new_residual = x.float()
    if residual is not None:
        new_residual = new_residual + residual.float()
    return layer_norm(new_residual, weight, bias, eps, out_dtype=x.dtype), new_residual


def init_layer_norm(dim: int, dtype=torch.float32, device="cuda") -> dict:
    return {"weight": torch.ones(dim, dtype=dtype, device=device),
            "bias": torch.zeros(dim, dtype=dtype, device=device)}
