"""Generation: KV-cached Backpack and GPT decode (greedy or sampled) and
the recompute oracle.

Port of ``backpacks_flash_attn_tpu/utils/generation.py`` (``_select_next``
:31, ``_decode_loop`` :58, ``generate_backpack`` :89, ``generate_gpt``
:120, ``generate_backpack_recompute`` :144).
PyTorch runs eagerly, so the decode loop is a Python loop over cached steps
(JAX compiles it as one scan). Sampling keys are ``utils.prng`` keys, split
as JAX splits them, and the Gumbel draw is ``jax.random.categorical``'s on
those keys.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import BackpackConfig, GPTConfig
from ..models import backpack as bp
from ..models import gpt as gpt_lib
from ..ops import _build
from . import prng


class GenerationOutput(NamedTuple):
    sequences: torch.Tensor           # (b, max_length)
    scores: Optional[torch.Tensor]    # (b, n_generated, vocab) or None


def _select_next(logits: torch.Tensor, rng: Optional[torch.Tensor],
                 temperature: float, top_k: int,
                 top_p: float = 1.0) -> torch.Tensor:
    """Greedy if rng is None, else temperature (+ optional top-k and/or
    nucleus top-p) sampling with ``rng``'s Gumbel draw (JAX :31)."""
    if rng is None:
        return logits.argmax(dim=-1)
    logits = logits.float() / max(temperature, 1e-6)
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p < 1.0:
        # keep the smallest prefix of descending-prob tokens with cumulative
        # probability > top_p (the last kept token crosses the threshold)
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        cutoff = torch.where(keep, sorted_logits, torch.inf).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return prng.categorical(rng, logits)


def _decode_loop(step_fn, first_logits: torch.Tensor, input_ids: torch.Tensor,
                 max_length: int, key: Optional[torch.Tensor],
                 temperature: float, top_k: int, top_p: float,
                 output_scores: bool) -> GenerationOutput:
    """The tokens after the prefill (JAX :58): token 0 from the prefill's
    last logits with ``fold_in(key, 0)``, then one cached step per token,
    token i sampled with ``fold_in(key, i + 1)`` as JAX's scan does; greedy
    when key is None. step_fn(ids (b, 1)) -> logits (b, 1, V)."""
    prompt_len = input_ids.shape[1]
    scores = [first_logits]
    tokens = [_select_next(first_logits, None if key is None
                           else prng.fold_in(key, 0), temperature, top_k,
                           top_p)]
    for i in range(1, max_length - prompt_len):
        scores.append(step_fn(tokens[-1][:, None])[:, -1])
        tokens.append(_select_next(
            scores[-1], None if key is None else prng.fold_in(key, i + 1),
            temperature, top_k, top_p))
    sequences = torch.cat([input_ids, torch.stack(tokens, dim=1)], dim=1)
    return GenerationOutput(
        sequences=sequences,
        scores=torch.stack(scores, dim=1) if output_scores else None)


def _check_length(input_ids: torch.Tensor, max_length: int) -> None:
    if max_length <= input_ids.shape[1]:
        raise ValueError(f"max_length {max_length} leaves no token to "
                         f"generate after a {input_ids.shape[1]}-token prompt")


@torch.inference_mode()
def generate_backpack(params, cfg: BackpackConfig, input_ids: torch.Tensor,
                      max_length: int, *, rng: Optional[torch.Tensor] = None,
                      greedy: Optional[bool] = None, temperature: float = 1.0,
                      top_k: int = 0, top_p: float = 1.0,
                      output_scores: bool = False,
                      sense_weights: Optional[torch.Tensor] = None,
                      sense_edit: Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]] = None,
                      cache_dtype=torch.bfloat16,
                      device="cuda") -> GenerationOutput:
    """Incremental Backpack generation: one prefill, then one cached decode
    step per new token, on a cache allocated on ``device``. Greedy unless
    ``rng`` (a ``utils.prng`` key) is given with a positive temperature;
    token t samples with ``fold_in(rng, t + 1)`` past the first, which
    takes ``fold_in(rng, 0)``, as JAX's scan does. sense_weights and
    sense_edit (``models/interventions.mogrify_word``'s pair) thread
    through every prefill and decode step (JAX :96)."""
    if greedy is None:
        greedy = rng is None or temperature <= 0
    if temperature <= 0:
        temperature = 1.0
    _check_length(input_ids, max_length)
    cache = bp.init_backpack_cache(cfg, input_ids.shape[0], max_length,
                                   cache_dtype, device=device)

    def step(ids):
        logits, _ = bp.backpack_forward_with_cache(
            params, cfg, ids, cache, sense_weights=sense_weights,
            sense_edit=sense_edit)
        return logits

    return _decode_loop(step, step(input_ids)[:, -1], input_ids, max_length,
                        None if greedy else rng, temperature, top_k, top_p,
                        output_scores)


@torch.inference_mode()
def generate_gpt(params, cfg: GPTConfig, input_ids: torch.Tensor,
                 max_length: int, *, rng: Optional[torch.Tensor] = None,
                 greedy: bool = True, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 output_scores: bool = False,
                 cache_dtype=torch.bfloat16,
                 device="cuda") -> GenerationOutput:
    """KV-cached GPT generation (JAX :120): the prompt prefilled into a
    ``max_length`` cache on ``device`` (flash forward, K3), then one cached
    step per new token (decode attention, K1), with the tied LM head.
    Greedy unless ``greedy`` is False and ``rng`` is given (JAX's
    defaults)."""
    _check_length(input_ids, max_length)
    cache = gpt_lib.init_kv_cache(cfg, input_ids.shape[0], max_length,
                                  cache_dtype, device=device)

    def step(ids):
        # only the last position's logits are read: the prefill skips the
        # LM head over the rest of the prompt
        hidden, _ = gpt_lib.gpt_forward_with_cache(params, cfg, ids, cache)
        return gpt_lib.lm_logits(params, cfg, hidden[:, -1:])

    return _decode_loop(step, step(input_ids)[:, -1], input_ids, max_length,
                        None if greedy else rng, temperature, top_k, top_p,
                        output_scores)


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
