"""Scaled masked softmax: the non-flash attention's softmax.

Port of ``backpacks_flash_attn_tpu/ops/softmax.py`` (:23-63), the semantics
of Megatron's ``scaled_masked_softmax`` / ``scaled_upper_triang_masked_softmax``
and the ``FusedScaleMaskSoftmax`` dispatcher with its input-dtype and
softmax-in-f32 knobs. Plain PyTorch: the JAX package has no kernel here
(XLA fuses scale, mask and softmax), so the port has none either.
"""

from __future__ import annotations

from typing import Optional

import torch

MASK_FILL = -10000.0


def scaled_masked_softmax(x: torch.Tensor, mask: Optional[torch.Tensor],
                          scale: float = 1.0) -> torch.Tensor:
    """softmax(x * scale) over the last axis in f32, with -10000 where
    ``mask`` is True (True = MASKED OUT, the reference kernel's convention).
    x (b, h, sq, sk); mask broadcasting to it, e.g. (b, 1, sq, sk). Returns
    x's dtype."""
    s = x.float() * scale
    if mask is not None:
        s = torch.where(mask, MASK_FILL, s)
    return torch.softmax(s, dim=-1).to(x.dtype)


def scaled_upper_triang_masked_softmax(x: torch.Tensor,
                                       scale: float = 1.0) -> torch.Tensor:
    """The causal form: softmax(x * scale) with the strict upper triangle
    (key past query) at -10000."""
    sq, sk = x.shape[-2], x.shape[-1]
    keep = (torch.arange(sk, device=x.device)[None, :]
            <= torch.arange(sq, device=x.device)[:, None])
    s = torch.where(keep, x.float() * scale, MASK_FILL)
    return torch.softmax(s, dim=-1).to(x.dtype)


class FusedScaleMaskSoftmax:
    """The reference module's dispatcher (causal or padded mask, the scale,
    softmax in f32); both forms are the plain functions above."""

    def __init__(self, *, causal: bool = False,
                 softmax_in_fp32: bool = True, scale: float = 1.0):
        self.causal = causal
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale

    def __call__(self, x: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.causal:
            out = scaled_upper_triang_masked_softmax(x, self.scale)
        else:
            out = scaled_masked_softmax(x, mask, self.scale)
        return out if self.softmax_in_fp32 else out.to(x.dtype)
