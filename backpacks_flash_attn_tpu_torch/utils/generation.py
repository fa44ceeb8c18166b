"""Greedy generation: KV-cached Backpack decode and the recompute oracle.

Port of ``backpacks_flash_attn_tpu/utils/generation.py``
(``generate_backpack`` :89, greedy; ``generate_backpack_recompute`` :144).
PyTorch runs eagerly, so the decode loop is a Python loop over cached steps
(JAX compiles it as one scan). Sampling, top-k/top-p and interventions come
with a later slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import BackpackConfig
from ..models import backpack as bp
from ..ops import _build


class GenerationOutput(NamedTuple):
    sequences: torch.Tensor           # (b, max_length)
    scores: Optional[torch.Tensor]    # (b, n_generated, vocab) or None


@torch.inference_mode()
def generate_backpack(params, cfg: BackpackConfig, input_ids: torch.Tensor,
                      max_length: int, *, output_scores: bool = False,
                      cache_dtype=torch.bfloat16,
                      device="cuda") -> GenerationOutput:
    """Incremental greedy Backpack generation: one prefill, then one cached
    decode step per new token, on a cache allocated on ``device``."""
    b, prompt_len = input_ids.shape
    if max_length <= prompt_len:
        raise ValueError(f"max_length {max_length} leaves no token to "
                         f"generate after a {prompt_len}-token prompt")
    cache = bp.init_backpack_cache(cfg, b, max_length, cache_dtype,
                                   device=device)
    logits, cache = bp.backpack_forward_with_cache(params, cfg, input_ids,
                                                   cache)
    scores = [logits[:, -1]]
    tokens = [scores[-1].argmax(dim=-1)]
    for _ in range(max_length - prompt_len - 1):
        logits, cache = bp.backpack_forward_with_cache(
            params, cfg, tokens[-1][:, None], cache)
        scores.append(logits[:, -1])
        tokens.append(scores[-1].argmax(dim=-1))
    sequences = torch.cat([input_ids, torch.stack(tokens, dim=1)], dim=1)
    return GenerationOutput(
        sequences=sequences,
        scores=torch.stack(scores, dim=1) if output_scores else None)


@torch.inference_mode()
def generate_backpack_recompute(params, cfg: BackpackConfig,
                                input_ids: torch.Tensor,
                                max_length: int) -> torch.Tensor:
    """Oracle decode that re-runs the full forward each step through the
    plain PyTorch versions of the kernels (``_build.plain_path()``); tests
    validate the incremental path against it token for token."""
    ids = input_ids
    with _build.plain_path():
        while ids.shape[1] < max_length:
            logits = bp.backpack_forward(params, cfg, ids)
            ids = torch.cat([ids, logits[:, -1].argmax(dim=-1)[:, None]],
                            dim=1)
    return ids
