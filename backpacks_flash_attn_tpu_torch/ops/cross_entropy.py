"""Softmax cross-entropy with label smoothing and an ignore index.

Port of ``backpacks_flash_attn_tpu/ops/cross_entropy.py`` (``cross_entropy``
:78, ``cross_entropy_loss`` :95). The JAX package computes it outside any
Pallas kernel, so it is plain PyTorch here as well. The backward saves the
logits in their own (typically bf16) dtype plus the per-row LSE and
recomputes the softmax from them (JAX ``_ce_fwd`` :46-55), instead of an
f32 copy of the whole (b, s, V) logits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _ce_fwd_math(logits, labels, label_smoothing, ignore_index, total):
    logits_f = logits.float()
    lse = torch.logsumexp(logits_f, dim=-1)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    ll = torch.gather(logits_f, -1, safe[..., None].long())[..., 0]
    if label_smoothing > 0.0:
        sum_logits = logits_f.sum(dim=-1)
        loss = ((1.0 - label_smoothing) * (lse - ll)
                + label_smoothing * (lse - sum_logits / total))
    else:
        loss = lse - ll
    return torch.where(valid, loss, torch.zeros_like(loss)), lse


class _CrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels, label_smoothing, ignore_index, total):
        loss, lse = _ce_fwd_math(logits, labels, label_smoothing,
                                 ignore_index, total)
        ctx.save_for_backward(logits, labels, lse)
        ctx.args = (label_smoothing, ignore_index, total)
        return loss, lse

    @staticmethod
    def backward(ctx, g_loss, g_lse):
        logits, labels, lse = ctx.saved_tensors
        label_smoothing, ignore_index, total = ctx.args
        valid = labels != ignore_index
        g_tok = torch.where(valid, g_loss, torch.zeros_like(g_loss))[..., None]
        # dloss/dlogit_c = p_c - [(1 - eps) 1[c = y] + eps / total], built
        # in place in one f32 (b, s, V) buffer
        dlogits = torch.exp(logits.float() - lse[..., None])
        dlogits.mul_(g_tok + g_lse[..., None])
        if label_smoothing > 0.0:
            dlogits.sub_(g_tok * (label_smoothing / total))
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        dlogits.scatter_add_(-1, safe[..., None].long(),
                             -g_tok * (1.0 - label_smoothing))
        return dlogits.to(logits.dtype), None, None, None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  label_smoothing: float = 0.0,
                  ignore_index: int = -100,
                  total_classes: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token loss and lse (f32). logits (..., V), labels (...) int.
    Smoothing spreads ``label_smoothing`` over ``total_classes`` (V by
    default); ignored tokens get loss 0."""
    total = total_classes if total_classes is not None else logits.shape[-1]
    return _CrossEntropy.apply(logits, labels, float(label_smoothing),
                               int(ignore_index), total)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       label_smoothing: float = 0.0,
                       ignore_index: int = -100) -> torch.Tensor:
    """Mean loss over the tokens that are not ignored."""
    loss, _ = cross_entropy(logits, labels, label_smoothing=label_smoothing,
                            ignore_index=ignore_index)
    valid = (labels != ignore_index).float()
    return loss.sum() / torch.clamp(valid.sum(), min=1.0)
