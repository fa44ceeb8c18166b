"""LayerNorm, dropout, and dropout+add+LayerNorm.

Port of ``backpacks_flash_attn_tpu/ops/norms.py`` (``layer_norm`` :26,
``_hash_mask`` :38, ``dropout`` :93 with its mask regenerated in the
backward and its global positions ``idx``, ``_daln_fused`` :121-175,
``dropout_add_layer_norm`` :178).
Statistics are f32 whatever the input dtype; the residual stream is carried
in f32 and the normalized output keeps the input dtype.

The per-token dropout masks come from the same counter hash as attention
dropout (``flash_attention.dropout_keep_positions``) over each element's
flat position, seeded by the site's key, so they are bit-identical to the
JAX package's and are recomputed, never stored, in the backward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import prng
from .flash_attention import dropout_keep_positions


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


def hash_mask(seed: Tuple[int, int], rate: float, shape,
              device=None, idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Keep mask over flat element positions (JAX ``_hash_mask`` :38): the
    attention hash with bh = 0, q_pos = the position, k_pos = 0. idx: the
    elements' GLOBAL flat positions (broadcast to shape), for a sharded
    caller (``parallel/cp_train.py``) whose chunk must draw the
    single-device mask; by default the positions of ``shape`` itself."""
    if idx is None:
        n = 1
        for d in shape:
            n *= d
        idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    else:
        idx = idx.to(device=device, dtype=torch.int64).expand(shape)
    return dropout_keep_positions(seed, 0, idx, 0, rate)


def _apply_mask(x, seed, rate, idx=None):
    mask = hash_mask(seed, rate, x.shape, x.device, idx)
    return torch.where(mask, x * (1.0 / (1.0 - rate)), torch.zeros_like(x))


class _Dropout(torch.autograd.Function):
    """Dropout whose backward regenerates the mask from the seed (JAX
    ``_recompute_dropout`` :62-103)."""

    @staticmethod
    def forward(ctx, x, rate, seed, idx):
        ctx.rate, ctx.seed, ctx.idx = rate, seed, idx
        return _apply_mask(x, seed, rate, idx)

    @staticmethod
    def backward(ctx, g):
        return _apply_mask(g, ctx.seed, ctx.rate, ctx.idx), None, None, None


def dropout(x: torch.Tensor, rate: float, rng: Optional[torch.Tensor],
            deterministic: bool,
            idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout with the hash mask; the identity when deterministic,
    at rate 0 or without a key. rng: a key of ``utils.prng``. idx: global
    flat positions (:func:`hash_mask`)."""
    if deterministic or rate == 0.0 or rng is None:
        return x
    return _Dropout.apply(x, float(rate), prng.seed_words(rng), idx)


def _daln_forward(x, residual, weight, bias, seed, rate, eps, out_dtype,
                  idx=None):
    y = _apply_mask(x, seed, rate, idx) if seed is not None else x
    nr = y.float() + residual.float()
    mean = nr.mean(dim=-1, keepdim=True)
    var = (nr - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    normed = ((nr - mean) * rstd * weight.float() + bias.float()).to(out_dtype)
    return normed, nr, mean, rstd


class _DropoutAddLayerNorm(torch.autograd.Function):
    """dropout(x) + residual -> LN, prenorm with an f32 residual (JAX
    ``_daln_fused`` :121-175): the mask is regenerated from the seed in the
    backward, and the saved copy of the f32 residual stream is bf16 (the
    compute stays f32, so the backward's x_hat sees a bf16-rounded
    residual)."""

    @staticmethod
    def forward(ctx, x, residual, weight, bias, seed, rate, eps, idx):
        normed, nr, mean, rstd = _daln_forward(x, residual, weight, bias,
                                               seed, rate, eps, x.dtype, idx)
        ctx.save_for_backward(nr.to(torch.bfloat16), mean, rstd, weight)
        ctx.seed, ctx.rate, ctx.x_dtype, ctx.idx = seed, rate, x.dtype, idx
        return normed, nr

    @staticmethod
    def backward(ctx, g_norm, g_nr):
        nr_b, mean, rstd, weight = ctx.saved_tensors
        x_hat = (nr_b.float() - mean) * rstd
        gn = g_norm.float()
        dxhat = gn * weight.float()
        dnr = rstd * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                      - x_hat * (dxhat * x_hat).mean(dim=-1, keepdim=True))
        if g_nr is not None:
            dnr = dnr + g_nr.float()
        red = tuple(range(gn.dim() - 1))
        dw = (gn * x_hat).sum(dim=red).to(weight.dtype)
        db = gn.sum(dim=red).to(weight.dtype)
        dx = dnr
        if ctx.seed is not None:
            dx = _apply_mask(dx, ctx.seed, ctx.rate, ctx.idx)
        return dx.to(ctx.x_dtype), dnr, dw, db, None, None, None, None


def dropout_add_layer_norm(
    x: torch.Tensor,
    residual: Optional[torch.Tensor],
    weight: torch.Tensor,
    bias: torch.Tensor,
    dropout_p: float = 0.0,
    eps: float = 1e-5,
    *,
    rng: Optional[torch.Tensor] = None,
    deterministic: bool = True,
    bf16_saves: bool = True,
    dropout_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dropout(x) + residual -> LayerNorm, the prenorm form. Returns
    (normalized in x's dtype, new_residual in f32).

    bf16_saves (the JAX package's ``BACKPACKS_DALN_BF16_SAVES``, on by
    default): with a residual, under autograd, the fused autograd Function
    whose saved residual is bf16; otherwise dropout and LayerNorm
    differentiate by autograd. The forward values are the same either
    way. dropout_idx: the elements' global flat positions (JAX :193-221),
    so that a sequence-sharded caller draws the single-device mask."""
    drop_active = not deterministic and dropout_p > 0.0 and rng is not None
    tracked = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, residual, weight, bias))
    if bf16_saves and residual is not None and tracked:
        seed = prng.seed_words(rng) if drop_active else None
        return _DropoutAddLayerNorm.apply(x, residual, weight, bias, seed,
                                          float(dropout_p), float(eps),
                                          dropout_idx)
    y = dropout(x, dropout_p, rng, deterministic, idx=dropout_idx)
    new_residual = y.float()
    if residual is not None:
        new_residual = new_residual + residual.float()
    return (layer_norm(new_residual, weight, bias, eps, out_dtype=x.dtype),
            new_residual)


def init_layer_norm(dim: int, dtype=torch.float32, device="cuda") -> dict:
    return {"weight": torch.ones(dim, dtype=dtype, device=device),
            "bias": torch.zeros(dim, dtype=dtype, device=device)}
