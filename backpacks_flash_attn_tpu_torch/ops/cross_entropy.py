"""Softmax cross-entropy with label smoothing and an ignore index.

Port of ``backpacks_flash_attn_tpu/ops/cross_entropy.py`` (``cross_entropy``
:78, ``cross_entropy_loss`` :95, ``vocab_parallel_cross_entropy`` :106). The JAX package computes it outside any
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


def vocab_parallel_cross_entropy(local_logits: torch.Tensor,
                                 labels: torch.Tensor, group, *,
                                 label_smoothing: float = 0.0,
                                 ignore_index: int = -100) -> torch.Tensor:
    """Per-token loss (f32) with the vocabulary sharded over the process
    group ``group`` (JAX :106, whose ``axis_name`` this is): local_logits
    (..., V / n) are this rank's columns [rank * V / n, (rank + 1) * V / n),
    labels GLOBAL ids. Each rank takes its local LSE, their log-sum-exp
    over the group is a max-shifted sum of exps, and the target logit is
    summed over the ranks (0 outside a rank's shard); ignored tokens give
    0. Differentiable through ``parallel/mesh.py``'s reduce_from, whose
    backward is the identity: the loss is the same on every rank, and each
    rank's backward gives the gradient of its own columns. None (or a
    group of one) is the unsharded loss."""
    from ..parallel import mesh as mesh_lib

    n = 1 if group is None else torch.distributed.get_world_size(group)
    local = local_logits.float()
    v_local = local.shape[-1]
    start = (torch.distributed.get_rank(group) if n > 1 else 0) * v_local
    local_lse = torch.logsumexp(local, dim=-1)
    m = (mesh_lib.group_max(local_lse.detach(), group) if n > 1
         else local_lse.detach())
    lse = m + torch.log(mesh_lib.reduce_from(torch.exp(local_lse - m), group))
    valid = labels != ignore_index
    local_label = labels - start
    in_shard = (local_label >= 0) & (local_label < v_local) & valid
    safe = local_label.clamp(0, v_local - 1)
    ll_local = torch.gather(local, -1, safe[..., None].long())[..., 0]
    ll = mesh_lib.reduce_from(torch.where(in_shard, ll_local, 0.0), group)
    if label_smoothing > 0.0:
        total = v_local * n
        sum_logits = mesh_lib.reduce_from(local.sum(dim=-1), group)
        loss = ((1.0 - label_smoothing) * (lse - ll)
                + label_smoothing * (lse - sum_logits / total))
    else:
        loss = lse - ll
    return torch.where(valid, loss, torch.zeros_like(loss))
