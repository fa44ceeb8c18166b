"""Rotary position embeddings (RoFormer) with optional XPos scaling.

Port of ``backpacks_flash_attn_tpu/ops/rotary.py`` (:33-101). The first
``rotary_dim`` channels of each head are rotated, x1 the first half of that
slice and x2 the second (GPT-NeoX's convention); the channels past it pass
through. With ``scale_base > 0`` (XPos) q is multiplied by
scale^((pos - center) / scale_base) and k by its inverse. There is no
kernel: JAX computes rotary in XLA, the port in a few elementwise ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rotary_inv_freq(rotary_dim: int, base: float = 10000.0,
                    device=None) -> torch.Tensor:
    """(rotary_dim / 2,) inverse frequencies (JAX :33)."""
    exps = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                        device=device) / rotary_dim
    return 1.0 / (base ** exps)


def rotary_cos_sin(positions: torch.Tensor, rotary_dim: int,
                   base: float = 10000.0, scale_base: int = 0,
                   center: int = 0,
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor], Optional[torch.Tensor]]:
    """cos/sin tables for (s,) or per-row (b, s) positions (JAX :39):
    (cos_q, sin_q, cos_k, sin_k), each positions.shape + (rot / 2,); the k
    pair is None unless XPos is on."""
    dev = positions.device
    inv_freq = rotary_inv_freq(rotary_dim, base, dev)
    pos = positions.to(torch.float32)
    freqs = pos[..., None] * inv_freq
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    if scale_base <= 0:
        return cos, sin, None, None
    scale = ((torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=dev)
              + 0.4 * rotary_dim) / (1.4 * rotary_dim))
    scale = scale ** ((pos - center) / scale_base)[..., None]
    return cos * scale, sin * scale, cos / scale, sin / scale


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    """x (b, s, h, d) with its first 2 * cos.shape[-1] channels rotated by
    the f32 tables cos, sin (1 or b, s, 1, rot / 2), in f32, returned in
    x's dtype."""
    half = cos.shape[-1]
    rotary_dim = 2 * half
    x1 = x[..., :half].float()
    x2 = x[..., half:rotary_dim].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                    dim=-1).to(x.dtype)
    if rotary_dim < x.shape[-1]:
        out = torch.cat([out, x[..., rotary_dim:]], dim=-1)
    return out


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """Rotate the first 2 * cos.shape[-1] channels of x (b, s, h, d) in f32
    and return x's dtype (JAX :60). cos/sin: (s, rot / 2) for every row or
    (b, s, rot / 2) per row."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    return _rotate(x, cos[:, :, None, :].float(), sin[:, :, None, :].float())


def rotary_tables(s: int, rotary_dim: int, *, seqlen_offset=0,
                  base: float = 10000.0, scale_base: int = 0, device=None
                  ) -> Tuple[torch.Tensor, ...]:
    """The tables of :func:`rotate_qk` at positions seqlen_offset + [0, s):
    (cos_q, sin_q, cos_k, sin_k), each (1 or b, s, 1, rot / 2) f32; k's are
    q's unless XPos is on. They depend only on the positions, so a forward
    builds them once and every layer's rotation reads them.
    seqlen_offset: an int, a 0-d tensor, or (b,) per-row offsets (serving
    slots)."""
    offs = torch.as_tensor(seqlen_offset, device=device)
    steps = torch.arange(s, device=device)
    positions = (offs[:, None] + steps[None, :] if offs.dim() == 1
                 else (offs + steps)[None])
    cos_q, sin_q, cos_k, sin_k = rotary_cos_sin(positions, rotary_dim,
                                                base=base,
                                                scale_base=scale_base)
    if cos_k is None:
        cos_k, sin_k = cos_q, sin_q
    return tuple(t[:, :, None, :] for t in (cos_q, sin_q, cos_k, sin_k))


def rotate_qk(q: torch.Tensor, k: torch.Tensor, tables
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q and k (b, s, h, d) rotated by :func:`rotary_tables`' tables."""
    cos_q, sin_q, cos_k, sin_k = tables
    return _rotate(q, cos_q, sin_q), _rotate(k, cos_k, sin_k)


def apply_rotary_qk(q: torch.Tensor, k: torch.Tensor, rotary_dim: int, *,
                    seqlen_offset=0, base: float = 10000.0,
                    scale_base: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary (or XPos) on q and k (b, s, h, d) at positions seqlen_offset +
    [0, s) (JAX :82). seqlen_offset: an int, a 0-d tensor, or (b,) per-row
    offsets (serving slots)."""
    if rotary_dim <= 0:
        return q, k
    return rotate_qk(q, k, rotary_tables(q.shape[1], rotary_dim,
                                         seqlen_offset=seqlen_offset,
                                         base=base, scale_base=scale_base,
                                         device=q.device))
