"""Padded batches and the packed layout: (b, s, ...) + mask <-> (budget, ...).

Port of ``backpacks_flash_attn_tpu/utils/padding.py`` (:23-68): pack the
real tokens of a padded batch (for per-token heads on real tokens only) in
the same stable batch-major order, padded to a static ``budget`` rows, and
scatter them back. Plain tensor indexing, differentiable through autograd.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Unpadded(NamedTuple):
    values: torch.Tensor       # (budget, ...) packed real tokens, then zeros
    indices: torch.Tensor      # (budget,) flat (b * s) source index of each row
    valid: torch.Tensor        # (budget,) bool, False on budget padding
    cu_seqlens: torch.Tensor   # (b + 1,) int32 prefix sums of the lengths
    max_seqlen: torch.Tensor   # 0-d int32


def _rows(valid: torch.Tensor, ndim: int) -> torch.Tensor:
    return valid.reshape((-1,) + (1,) * (ndim - 1))


def unpad_input(x: torch.Tensor, mask: torch.Tensor,
                budget: Optional[int] = None) -> Unpadded:
    """Pack the True-masked tokens of x (b, s, ...) into (budget, ...),
    real tokens first in batch-major order (a stable sort of the flat
    mask), the rest zeros. mask: (b, s) bool; budget: rows (default
    b * s)."""
    b, s = mask.shape
    budget = budget if budget is not None else b * s
    flat_mask = mask.reshape(-1).to(torch.bool)
    order = torch.argsort((~flat_mask).to(torch.int8), stable=True)
    indices = order[:budget]
    valid = flat_mask[indices]
    values = x.reshape((b * s,) + tuple(x.shape[2:]))[indices]
    values = torch.where(_rows(valid, values.dim()), values,
                         torch.zeros((), dtype=values.dtype,
                                     device=values.device))
    seqlens = mask.sum(dim=1).to(torch.int32)
    cu = torch.cat([torch.zeros(1, dtype=torch.int32, device=mask.device),
                    torch.cumsum(seqlens, 0).to(torch.int32)])
    return Unpadded(values=values, indices=indices, valid=valid,
                    cu_seqlens=cu, max_seqlen=seqlens.max())


def pad_input(unpadded: Unpadded, batch: int, seqlen: int) -> torch.Tensor:
    """Scatter the packed values back to (b, s, ...), zeros at padding."""
    values, indices, valid = (unpadded.values, unpadded.indices,
                              unpadded.valid)
    safe_idx = torch.where(valid, indices, batch * seqlen - 1)
    contrib = torch.where(_rows(valid, values.dim()), values,
                          torch.zeros((), dtype=values.dtype,
                                      device=values.device))
    flat = torch.zeros((batch * seqlen,) + tuple(values.shape[1:]),
                       dtype=values.dtype, device=values.device)
    flat = flat.index_add(0, safe_idx, contrib)
    return flat.reshape((batch, seqlen) + tuple(values.shape[1:]))


def index_first_axis(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Differentiable gather on axis 0."""
    return x[indices]
