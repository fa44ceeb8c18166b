"""FlashAttention forward (kernel K3), inference only.

Port of the forward of ``backpacks_flash_attn_tpu/ops/flash_attention.py``
(``flash_attention`` :1039 -> ``_flash_fwd`` :298 -> ``_flash_fwd_kernel``
:158) for causal masking, per-sequence ``seq_lengths`` and ``q_offsets``:
key column u of sequence b is valid when ``u < min(seq_lengths[b], sk)``
and, if causal, ``u <= q_offsets[b] + i`` for query row i. Fully masked rows
give 0 and an LSE of ``NEG_INF``. Dropout, an additive bias and block masks
come with the training and long-context slices.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import _build

# Large negative instead of -inf: keeps exp(m_prev - m_new) finite for
# fully-masked tiles.
NEG_INF = -0.7 * float(np.finfo(np.float32).max)
_K3 = _build.KERNELS["flash_attention"]


def _per_seq(x, b: int, device, default: int) -> torch.Tensor:
    if x is None:
        return torch.full((b,), default, dtype=torch.int64, device=device)
    return torch.as_tensor(x, device=device).reshape(-1).expand(b)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        softmax_scale: Optional[float] = None,
                        seq_lengths=None, q_offsets=None,
                        return_lse: bool = False):
    """Plain version of K3: the two products in the working dtype (bf16
    stays bf16), scores and softmax in f32, with the kernel's masks and
    its zero output for fully masked rows."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    s = torch.einsum("bthd,bshd->bhts", q, k.to(q.dtype)).float() * scale
    lens = _per_seq(seq_lengths, b, dev, sk)
    k_pos = torch.arange(sk, device=dev)
    mask = (k_pos[None, :] < torch.clamp(lens, max=sk)[:, None])[:, None, None, :]
    if causal:
        q_pos = (_per_seq(q_offsets, b, dev, 0)[:, None]
                 + torch.arange(sq, device=dev)[None, :])          # (b, sq)
        mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])[:, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhts,bshd->bthd", p.to(q.dtype), v.to(q.dtype)).float()
    out = (o / l_safe.permute(0, 2, 1, 3)).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l_safe))[..., 0]
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    softmax_scale: Optional[float] = None,
                    seq_lengths=None,
                    dropout_p: float = 0.0,
                    q_offsets=None,
                    attn_bias=None,
                    blockmask=None,
                    return_lse: bool = False):
    """q (b, sq, h, d); k, v (b, sk, h, d) -> (b, sq, h, d) in q's dtype
    [, lse (b, h, sq) f32]. CPU tensors, and every call inside
    ``_build.plain_path()``, take :func:`flash_attention_ref`; otherwise a
    CUDA tensor launches K3 (``csrc/flash_attention.cu``: bf16 or f32,
    d = 64, any outer strides) or raises."""
    if dropout_p > 0.0 or attn_bias is not None or blockmask is not None:
        raise NotImplementedError("dropout, attn_bias and blockmask come "
                                  "with the training and long-context slices")
    if not q.is_cuda or not _build.kernels_enabled():
        return flash_attention_ref(q, k, v, causal=causal,
                                   softmax_scale=softmax_scale,
                                   seq_lengths=seq_lengths,
                                   q_offsets=q_offsets, return_lse=return_lse)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dtypes = (torch.bfloat16, torch.float32)
    _build.check_cuda_tensor("q", q, dtypes, 4)
    _build.check_cuda_tensor("k", k, (q.dtype,), 4)
    _build.check_cuda_tensor("v", v, (q.dtype,), 4)
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} disagree")
    if d != 64:
        raise ValueError(f"flash_attention kernel takes head dim 64, got {d}")
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    lens = _per_seq(seq_lengths, b, q.device, sk).to(torch.int32).contiguous()
    offs = _per_seq(q_offsets, b, q.device, 0).to(torch.int32).contiguous()
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    P = _build.Ptr.of
    _build.launch(
        _K3, "flash_attention_launch", P(q), P(k), P(v), P(out), P(lse),
        P(lens), P(offs), b, h, sq, sk,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(scale), int(causal), _build.DTYPE_CODE[q.dtype])
    return (out, lse) if return_lse else out
