"""Synthetic corpora with known statistics.

A numpy-only copy of ``backpacks_flash_attn_tpu/data/synthetic.py``: the
same seed gives the same corpus in both packages.

The released Backpack checkpoints and OpenWebText are network-gated in some
environments (BASELINE.md measurement points); a sparse-Zipf bigram language
gives a trainable corpus with a KNOWN entropy floor so the quantization
ppl-delta gates (eval/quant_gates.py) can be exercised end-to-end against
really-trained weights anywhere.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def bigram_corpus(n_tokens: int, *, vocab_size: int = 50257,
                  n_successors: int = 24, zipf: float = 1.2,
                  seed: int = 0) -> Tuple[np.ndarray, float]:
    """Sample a random walk over a sparse bigram chain.

    Each token has `n_successors` fixed successors with Zipf(zipf) weights.
    Returns (tokens uint16/uint32, per-token entropy floor in nats) — a
    perfectly-fit model reaches ppl == exp(floor).
    """
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab_size, (vocab_size, n_successors)).astype(
        np.int64)
    w = 1.0 / np.arange(1, n_successors + 1) ** zipf
    w = w / w.sum()
    choices = rng.choice(n_successors, size=n_tokens, p=w)
    dtype = np.uint16 if vocab_size < 2 ** 16 else np.uint32
    toks = np.empty(n_tokens, dtype)
    t = int(rng.integers(0, vocab_size))
    CH = 100_000
    pos = 0
    while pos < n_tokens:
        end = min(pos + CH, n_tokens)
        c = choices[pos:end]
        out = np.empty(end - pos, np.int64)
        for i in range(end - pos):
            t = succ[t, c[i]]
            out[i] = t
        toks[pos:end] = out.astype(dtype)
        pos = end
    floor = float(-(w * np.log(w)).sum())
    return toks, floor
