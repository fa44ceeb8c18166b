"""Multi-head attention: the plain reference and the entry to K3/K5.

Port of ``backpacks_flash_attn_tpu/ops/attention.py`` (``mha_reference``
:50, ``mha`` :81, ``mha_qkv_packed`` :117, and the single-step cache
attention over the (b, S, h, dh) layout, ``decode_attention`` :143 and
``decode_attention_quant`` :167). Layout (b, s, h, dh) as in the JAX
package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..utils import prng
from .flash_attention import flash_attention, flash_attention_qkv_packed

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
                  q_offset=0,
                  dropout_p: float = 0.0,
                  dropout_rng: Optional[torch.Tensor] = None,
                  deterministic: bool = True) -> torch.Tensor:
    """Reference attention in f32, O(s^2) memory. q (b, sq, h, dh); k, v
    (b, sk, h, dh) -> (b, sq, h, dh) in q's dtype. Scale applied to k,
    additive -10000 masks. Dropout (not ``deterministic``, a key
    ``dropout_rng`` of ``utils.prng``) drops softmax probabilities with
    JAX's ``jax.random.bernoulli`` draw over (b, h, sq, sk), bit for bit
    (JAX :50-78)."""
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / math.sqrt(q.shape[-1]))
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float() * scale)
    scores = _apply_masks(scores, causal=causal,
                          key_padding_mask=key_padding_mask, q_offset=q_offset)
    attn = torch.softmax(scores, dim=-1)
    if dropout_p > 0.0 and not deterministic and dropout_rng is not None:
        keep = prng.bernoulli(dropout_rng, 1.0 - dropout_p, attn.shape,
                              attn.device)
        attn = torch.where(keep, attn / (1.0 - dropout_p), 0.0)
    return torch.einsum("bhts,bshd->bthd", attn, v.float()).to(q.dtype)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True,
        softmax_scale: Optional[float] = None,
        key_padding_mask: Optional[torch.Tensor] = None,
        seq_lengths: Optional[torch.Tensor] = None,
        dropout_p: float = 0.0,
        dropout_rng: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        q_offset=0, bh_offset: int = 0, head_offset: int = 0,
        global_heads: Optional[int] = None) -> torch.Tensor:
    """Attention entry point of the model code (JAX :81): the flash wrapper
    (K3, K5 backward), with in-kernel dropout when ``deterministic`` is
    False. q_offset: scalar or (b,) absolute position of q row 0.
    bh_offset, head_offset, global_heads: this call's rows and heads within
    an unsharded call (a data and head shard, ``training/train.py``'s
    sharded step), which key the dropout mask (see ``flash_attention``).
    key_padding_mask: (b, sk) True = a real key; as in JAX (:99-100) it
    becomes ``seq_lengths = mask.sum(-1)``, which reads the mask as right
    padding (every real key before every pad key), and takes the ragged
    flash entry (forward only on the card)."""
    dropout_active = dropout_p > 0.0 and not deterministic
    has_offset = not (isinstance(q_offset, int) and q_offset == 0)
    if key_padding_mask is not None and seq_lengths is None:
        seq_lengths = key_padding_mask.sum(-1).to(torch.int32)
    return flash_attention(q, k, v, causal=causal, softmax_scale=softmax_scale,
                           seq_lengths=seq_lengths,
                           dropout_p=dropout_p if dropout_active else 0.0,
                           dropout_rng=dropout_rng if dropout_active else None,
                           q_offsets=q_offset if has_offset else None,
                           bh_offset=bh_offset, head_offset=head_offset,
                           global_heads=global_heads)


def mha_qkv_packed(qkv: torch.Tensor, *, causal: bool = True,
                   softmax_scale: Optional[float] = None,
                   dropout_p: float = 0.0,
                   dropout_rng: Optional[torch.Tensor] = None,
                   deterministic: bool = True) -> torch.Tensor:
    """Fused-QKV self-attention entry (JAX :117): qkv (b, s, 3, h, dh) ->
    (b, s, h, dh) through :func:`flash_attention_qkv_packed` (K3, K5
    backward), dropout as in :func:`mha`."""
    dropout_active = dropout_p > 0.0 and not deterministic
    return flash_attention_qkv_packed(
        qkv, causal=causal, softmax_scale=softmax_scale,
        dropout_p=dropout_p if dropout_active else 0.0,
        dropout_rng=dropout_rng if dropout_active else None)


def _cache_softmax(scores: torch.Tensor, cache_len) -> torch.Tensor:
    """softmax over the cache columns of scores (b, h, t, S), the columns
    at or past cache_len (scalar or (b,)) masked with -10000 (JAX's
    MASK_VALUE, not NEG: a row with no valid column attends uniformly)."""
    b, S = scores.shape[0], scores.shape[-1]
    lens = torch.as_tensor(cache_len, device=scores.device).reshape(-1, 1)
    valid = torch.arange(S, device=scores.device)[None, :] < lens.expand(b, 1)
    return torch.softmax(torch.where(valid[:, None, None, :], scores,
                                     MASK_VALUE), dim=-1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Single-step attention over a (b, S, h, dh) cache (JAX :143): q (b,
    1, h, dh), cache_len (b,) or scalar valid positions. As JAX, the scale
    multiplies k in its dtype, the products sum in f32 and the
    probabilities take v's dtype. Plain PyTorch on every device (JAX's is an
    XLA contraction; the port's cache decode runs K1 over the flat-E
    layouts of ``ops/decode_attention.py``)."""
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / math.sqrt(q.shape[-1]))
    scores = torch.einsum("bthd,bshd->bhts", q.float(),
                          (k_cache * scale).float())
    attn = _cache_softmax(scores, cache_len).to(v_cache.dtype)
    return torch.einsum("bhts,bshd->bthd", attn.float(),
                        v_cache.float()).to(q.dtype)


def decode_attention_quant(q: torch.Tensor, k_cache: torch.Tensor,
                           k_scale: torch.Tensor, v_cache: torch.Tensor,
                           v_scale: torch.Tensor, cache_len, *,
                           softmax_scale: Optional[float] = None) -> torch.Tensor:
    """:func:`decode_attention` over an INT8 (b, S, h, dh) cache with (b, S,
    h, 1) f32 scales folded into the scores and the probabilities (JAX
    :167); the probabilities and the cache take q's dtype. Plain PyTorch on
    every device, as :func:`decode_attention`."""
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / math.sqrt(q.shape[-1]))
    cdt = q.dtype
    scores = torch.einsum("bthd,bshd->bhts", (q * scale).float(),
                          k_cache.to(cdt).float())
    scores = scores * k_scale[..., 0].permute(0, 2, 1)[:, :, None, :]
    attn = _cache_softmax(scores, cache_len)
    attn = (attn * v_scale[..., 0].permute(0, 2, 1)[:, :, None, :]).to(cdt)
    return torch.einsum("bhts,bshd->bthd", attn.float(),
                        v_cache.to(cdt).float()).to(cdt)
