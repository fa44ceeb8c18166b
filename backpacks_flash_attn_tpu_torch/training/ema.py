"""Exponential moving average of parameters.

Port of ``backpacks_flash_attn_tpu/training/ema.py``: a shadow copy of the
parameter tree folded towards the live parameters after each step, with the
warmup d = min(decay, (1 + n) / (10 + n)). The shadow is updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class EMAState:
    shadow: Any          # tree like params, never aliasing them
    num_updates: int = 0


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _map2(a, b, fn):
    if isinstance(a, dict):
        return {k: _map2(a[k], b[k], fn) for k in a}
    return fn(a, b)


def init_ema(params) -> EMAState:
    return EMAState(shadow=_map(params, lambda t: t.detach().clone()))


@torch.no_grad()
def ema_update(state: EMAState, params, decay: float,
               use_num_updates: bool = True) -> EMAState:
    """shadow <- d * shadow + (1 - d) * params; integer leaves are copied."""
    n = state.num_updates + 1
    d = min(decay, (1.0 + n) / (10.0 + n)) if use_num_updates else decay

    def fold(s, p):
        if s.is_floating_point():
            s.mul_(d).add_(p.detach().to(s.dtype), alpha=1.0 - d)
        else:
            s.copy_(p)
        return s

    return EMAState(shadow=_map2(state.shadow, params, fold), num_updates=n)
