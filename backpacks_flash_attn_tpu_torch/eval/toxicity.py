"""Toxicity suppression experiment (PyTorch port).

Port of ``backpacks_flash_attn_tpu/eval/toxicity.py``: a -1 bag-of-words
target over toxic tokens, the senses localized against it, their scores
bucketed into a (V, nv) table (modifiers [8.5, 1.1, 1, 1]), generation with
the O(t) negative-weighted decode
(``models/interventions.negative_decode_step``, anneal off), and an
optional pluggable toxicity scorer.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import BackpackConfig
from ..models import backpack as bp
from ..models import interventions as iv
from .control import (_buckets, _next_tokens, _on_device, _params_device,
                      sense_vocab_scores)

# reference test_toxicity.py:166-184: modifier_dict[0]
TOXICITY_MODIFIERS: List[float] = [8.5, 1.1, 1.0, 1.0]

# reference test_toxicity.py:155-158: the toxic bag of words (with a leading
# space; the caller's tokenizer resolves the ids)
TOXIC_WORDS = (" hate", " ugly", " idiot", " terror", " fuck")


def negative_target_vector(word_ids: Sequence[int], vocab_size: int,
                           device="cpu") -> torch.Tensor:
    """-1 bag-of-words target (JAX :37): senses aligned with toxic tokens
    score low, so the top buckets are the anti-toxic senses."""
    v = torch.zeros((vocab_size,), dtype=torch.float32, device=device)
    ids = list(word_ids)
    if ids:
        v[torch.as_tensor(ids, dtype=torch.long, device=device)] = -1.0
    return v


def ninety_weights_from_scores(scores: torch.Tensor,
                               quantile_weights: Sequence[float] =
                               tuple(TOXICITY_MODIFIERS)) -> torch.Tensor:
    """90/80/60-quantile bucketing (JAX :49): (nv, V) -> (V, nv)."""
    s = scores.float()
    q90, q80, q60 = _buckets(s, (0.90, 0.80, 0.60))
    w = torch.ones_like(s)
    w = torch.where(q90 < s, quantile_weights[0], w)
    w = torch.where((q80 < s) & (s < q90), quantile_weights[1], w)
    w = torch.where((q60 < s) & (s < q80), quantile_weights[2], w)
    w = torch.where(s < q60, quantile_weights[3], w)
    return w.T


def toxicity_weights(params, cfg: BackpackConfig,
                     toxic_word_ids: Sequence[int], *,
                     modifiers: Sequence[float] = tuple(TOXICITY_MODIFIERS),
                     chunk: int = 512):
    """Toxic words -> (V, nv) table and annealing scale max(modifiers) / 25
    (JAX :64)."""
    tv = negative_target_vector(toxic_word_ids, cfg.padded_vocab_size,
                                _params_device(params))
    scores = sense_vocab_scores(params, cfg, tv, chunk=chunk)
    return (ninety_weights_from_scores(scores, modifiers),
            max(modifiers) / 25.0)


@torch.no_grad()
def generate_negative(params, cfg: BackpackConfig, prompt_ids, table, *,
                      max_new_tokens: int = 64, quantile: float = 0.02,
                      anneal: bool = False, annealing_scale: float = 0.34,
                      temperature: float = 0.0,
                      generator: Optional[torch.Generator] = None,
                      max_seqlen: Optional[int] = None) -> np.ndarray:
    """Suppressed generation with the O(t) negative-weighted decode over a
    bf16 cache (JAX :77); samples from ``generator`` when it and a
    temperature are given. prompt_ids (b, p) -> (b, max_new_tokens)."""
    dev = _params_device(params)
    prompt = _on_device(prompt_ids, dev, torch.long)
    b, p = prompt.shape
    S = max_seqlen or (p + max_new_tokens)
    table = _on_device(table, dev, torch.float32)
    cache = bp.init_backpack_cache(cfg, b, S, torch.bfloat16, device=dev)
    state = iv.init_negative_decode_state(cfg, b, S, quantile=quantile,
                                          device=dev)
    kw = dict(anneal=anneal, annealing_scale=annealing_scale,
              quantile=quantile)
    logits, cache, state = iv.negative_decode_step(params, cfg, prompt, cache,
                                                   state, table, **kw)
    out = []
    for i in range(max_new_tokens):
        tok = _next_tokens(logits[:, -1], temperature, generator)
        out.append(tok)
        if i < max_new_tokens - 1:
            logits, cache, state = iv.negative_decode_step(
                params, cfg, tok, cache, state, table, **kw)
    return torch.cat(out, dim=1).cpu().numpy().astype(np.int32)


def run_toxicity_experiment(params, cfg: BackpackConfig,
                            toxic_word_ids: Sequence[int], prompt_ids, *,
                            modifiers: Sequence[float] =
                            tuple(TOXICITY_MODIFIERS),
                            max_new_tokens: int = 32,
                            temperature: float = 1.0,
                            generator: Optional[torch.Generator] = None,
                            scorer: Optional[Callable] = None,
                            include_baseline: bool = True,
                            chunk: int = 512) -> Dict[str, Dict]:
    """Localize -> table -> suppressed (and baseline, all-ones table)
    generations -> scorer(generations) when given, with the reference's
    ratio (score > 0.5) and mean when it returns a 'toxicity' vector (JAX
    :113). Greedy unless a generator is given."""
    table, ann = toxicity_weights(params, cfg, toxic_word_ids,
                                  modifiers=modifiers, chunk=chunk)
    runs = {"suppressed": table}
    if include_baseline:
        runs["baseline"] = torch.ones_like(table)
    results: Dict[str, Dict] = {}
    for name, tbl in runs.items():
        gens = generate_negative(params, cfg, prompt_ids, tbl, anneal=False,
                                 annealing_scale=ann,
                                 max_new_tokens=max_new_tokens,
                                 temperature=temperature, generator=generator)
        entry: Dict = {"generations": gens}
        if scorer is not None:
            metrics = scorer(gens)
            entry["metrics"] = metrics
            tox = np.asarray(metrics.get("toxicity", []), np.float32)
            if tox.size:
                entry["ratio"] = float((tox > 0.5).mean())
                entry["avg"] = float(tox.mean())
        results[name] = entry
    return results
