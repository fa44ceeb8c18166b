"""Perplexity evaluation: ppl = exp of the token-weighted mean NLL,
accumulated in float64 on the host.

Port of ``backpacks_flash_attn_tpu/eval/perplexity.py`` (``batch_nll``,
``PerplexityAccumulator``, ``evaluate_perplexity``), which the training CLI
calls at the end of a run.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..data.lm_dataset import LMDataset
from ..ops import _build
from ..ops.cross_entropy import cross_entropy


def batch_nll(logits: torch.Tensor, targets: torch.Tensor,
              ignore_index: int = -100) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of per-token NLL, number of counted tokens) for one batch."""
    loss, _ = cross_entropy(logits, targets, ignore_index=ignore_index)
    return loss.sum(), (targets != ignore_index).sum()


class PerplexityAccumulator:
    """Streaming ppl/NLL in float64."""

    def __init__(self) -> None:
        self.total_nll = np.float64(0.0)
        self.total_tokens = np.int64(0)

    def update(self, sum_nll, count) -> None:
        self.total_nll += np.float64(float(sum_nll))
        self.total_tokens += np.int64(int(count))

    @property
    def nll(self) -> float:
        return float(self.total_nll / max(int(self.total_tokens), 1))

    @property
    def ppl(self) -> float:
        return float(np.exp(self.nll))


@torch.no_grad()
def evaluate_perplexity(forward_fn: Callable[..., torch.Tensor],
                        tokens: np.ndarray, seqlen: int, batch_size: int,
                        *, max_batches: Optional[int] = None, params=None,
                        device="cuda") -> Dict[str, float]:
    """OWT-val style ppl over a flat token array: non-overlapping seqlen
    windows (lm_dataset semantics) through ``forward_fn(params, ids)`` (or
    ``forward_fn(ids)`` when params is None) on ``device``."""
    device = _build.resolve_device(device)
    ds = LMDataset(tokens, seqlen)
    acc = PerplexityAccumulator()
    n_batches = len(ds) // batch_size
    if max_batches is not None:
        n_batches = min(n_batches, max_batches)
    for b in range(n_batches):
        x, y = ds.batch(np.arange(b * batch_size, (b + 1) * batch_size))
        x = torch.from_numpy(x).long().to(device)
        y = torch.from_numpy(y).long().to(device)
        logits = forward_fn(x) if params is None else forward_fn(params, x)
        acc.update(*batch_nll(logits, y))
    return {"ppl": acc.ppl, "nll": acc.nll,
            "num_tokens": int(acc.total_tokens)}
