"""Multi-head attention: the plain reference and the entry to K3/K5.

Port of ``backpacks_flash_attn_tpu/ops/attention.py`` (``mha_reference``
:50, ``mha`` :81). Layout (b, s, h, dh) as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .flash_attention import flash_attention

# The reference's additive mask constant.
MASK_VALUE = -10000.0


def _apply_masks(scores: torch.Tensor, *, causal: bool,
                 key_padding_mask: Optional[torch.Tensor],
                 q_offset=0) -> torch.Tensor:
    """scores (b, h, sq, sk); key_padding_mask (b, sk) True=keep; q_offset
    scalar or (b,) absolute position of q row 0."""
    b, h, sq, sk = scores.shape
    dev = scores.device
    if key_padding_mask is not None:
        pad = torch.where(key_padding_mask, 0.0, MASK_VALUE).to(scores.dtype)
        scores = scores + pad[:, None, None, :]
    if causal:
        q_pos = torch.arange(sq, device=dev)[:, None]
        k_pos = torch.arange(sk, device=dev)[None, :]
        off = torch.as_tensor(q_offset, dtype=torch.int64, device=dev)
        if off.dim() == 1:
            keep = k_pos[None] <= q_pos[None] + off[:, None, None]
            cmask = torch.where(keep, 0.0, MASK_VALUE).to(scores.dtype)
            scores = scores + cmask[:, None]
        else:
            cmask = torch.where(k_pos <= q_pos + off, 0.0,
                                MASK_VALUE).to(scores.dtype)
            scores = scores + cmask[None, None]
    return scores


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  softmax_scale: Optional[float] = None,
                  key_padding_mask: Optional[torch.Tensor] = None,
                  q_offset=0) -> torch.Tensor:
    """Reference attention in f32, O(s^2) memory. q (b, sq, h, dh); k, v
    (b, sk, h, dh) -> (b, sq, h, dh) in q's dtype. Scale applied to k,
    additive -10000 masks."""
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / math.sqrt(q.shape[-1]))
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float() * scale)
    scores = _apply_masks(scores, causal=causal,
                          key_padding_mask=key_padding_mask, q_offset=q_offset)
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", attn, v.float()).to(q.dtype)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True,
        softmax_scale: Optional[float] = None,
        seq_lengths: Optional[torch.Tensor] = None,
        dropout_p: float = 0.0,
        dropout_rng: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        q_offset=0) -> torch.Tensor:
    """Attention entry point of the model code (JAX :81): the flash wrapper
    (K3, K5 backward), with in-kernel dropout when ``deterministic`` is
    False. q_offset: scalar or (b,) absolute position of q row 0."""
    dropout_active = dropout_p > 0.0 and not deterministic
    has_offset = not (isinstance(q_offset, int) and q_offset == 0)
    return flash_attention(q, k, v, causal=causal, softmax_scale=softmax_scale,
                           seq_lengths=seq_lengths,
                           dropout_p=dropout_p if dropout_active else 0.0,
                           dropout_rng=dropout_rng if dropout_active else None,
                           q_offsets=q_offset if has_offset else None)
