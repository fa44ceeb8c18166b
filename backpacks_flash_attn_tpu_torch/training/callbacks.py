"""Observability callbacks: speed, norms, metrics logging, FLOPs.

Port of ``backpacks_flash_attn_tpu/training/callbacks.py`` (``SpeedMonitor``,
``norm_stats``, ``MetricsLogger``, ``flop_count``). The JAX package counts
FLOPs with XLA's cost analysis; a counter of torch's dispatch would not see
the ctypes kernels, so :func:`flop_count` is the analytic count.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


class SpeedMonitor:
    """Intra/inter-step times and tokens/s on the host clock. A caller that
    times device work synchronizes before ``on_step_end``."""

    def __init__(self) -> None:
        self._step_start: Optional[float] = None
        self._last_end: Optional[float] = None

    def on_step_start(self) -> Dict[str, float]:
        now = time.perf_counter()
        out = {}
        if self._last_end is not None:
            out["time/inter_step_ms"] = (now - self._last_end) * 1e3
        self._step_start = now
        return out

    def on_step_end(self, tokens_in_batch: Optional[int] = None
                    ) -> Dict[str, float]:
        now = time.perf_counter()
        out = {}
        if self._step_start is not None:
            dt = now - self._step_start
            out["time/intra_step_ms"] = dt * 1e3
            if tokens_in_batch:
                out["throughput/tokens_per_s"] = tokens_in_batch / dt
        self._last_end = now
        return out


def norm_stats(tree, prefix: str) -> Dict[str, float]:
    """Per-leaf L2 norms of the floating-point tensors of a nested-dict
    tree, plus their global norm under ``{prefix}/total``."""
    out: Dict[str, float] = {}

    def walk(node, key):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{key}/{k}" if key else str(k))
        elif isinstance(node, torch.Tensor) and node.is_floating_point():
            out[f"{prefix}/{key}"] = float(torch.linalg.vector_norm(
                node.detach().float()))

    walk(tree, "")
    out[f"{prefix}/total"] = sum(v * v for v in out.values()) ** 0.5
    return out


def n_params(params) -> int:
    if isinstance(params, dict):
        return sum(n_params(v) for v in params.values())
    return params.numel()


def flop_count(cfg, params, batch_size: int, seqlen: int) -> float:
    """Analytic FLOPs of one training step (forward + backward):

        6 * N * tokens                        (every weight, incl. the tied
                                               LM head, in 3 products)
      + 6 * tokens * n_layer * 2 * s * d      (QK^T and PV per layer)
      + 6 * tokens * s * nv * (dnv + d)       (Backpack: alpha and alpha @ C)

    with N the parameter count, tokens = batch_size * seqlen, s = seqlen;
    the attention terms count the full s x s square (no causal halving),
    the usual MFU convention."""
    tokens = batch_size * seqlen
    n = n_params(params)
    flops = 6.0 * n * tokens
    flops += 6.0 * tokens * cfg.n_layer * 2 * seqlen * cfg.n_embd
    if hasattr(cfg, "num_senses"):
        flops += (6.0 * tokens * seqlen * cfg.num_senses
                  * (cfg.sense_head_dim + cfg.n_embd))
    return flops


class MetricsLogger:
    """JSONL metrics sink, with a one-line print every ``print_every``
    steps."""

    def __init__(self, path: Optional[str] = None, print_every: int = 0):
        self.path = path
        self.print_every = print_every
        self._fh = open(path, "a") if path else None

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        rec: Dict[str, Any] = {"step": step}
        rec.update({k: (float(v) if isinstance(
            v, (torch.Tensor, int, float, np.floating, np.integer)) else v)
            for k, v in metrics.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.print_every and step % self.print_every == 0:
            brief = " ".join(f"{k}={v:.4g}" for k, v in rec.items()
                             if isinstance(v, float))
            print(f"[step {step}] {brief}")

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
