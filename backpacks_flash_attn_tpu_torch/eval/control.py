"""Topic control and sense-vocabulary introspection (PyTorch port).

Port of ``backpacks_flash_attn_tpu/eval/control.py``: localize the senses
that point at a bag of target words, bucket their scores into a (V, nv)
multiplicative weight table, and generate with the O(t) annealed decode
(``models/interventions.weighted_decode_step``). The external scorers (a
topic classifier, a larger LM's NLL, MAUVE) are pluggable callables.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import BackpackConfig
from ..models import backpack as bp
from ..models import interventions as iv

# strength -> quantile multipliers (reference test_topic.py modifier_dict)
STRENGTH_MODIFIERS: Dict[int, List[float]] = {
    0: [1.0, 1.0, 1.0, 1.0],
    1: [1.5, 1.5, 1.3, 1.0],
    2: [2.2, 2.2, 1.5, 1.0],
    3: [3.3, 3.3, 3.0, 1.0],
}


def _params_device(params) -> torch.device:
    """The device a parameter tree lies on."""
    return params["gpt"]["ln_0"]["weight"].device


def _on_device(x, device, dtype) -> torch.Tensor:
    """A tensor, array or nested list as a ``dtype`` tensor on ``device``
    (arrays copied)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def target_vector(word_ids: Sequence[int], vocab_size: int,
                  device="cpu") -> torch.Tensor:
    """One-hot bag-of-words target over the vocabulary (JAX :38)."""
    v = torch.zeros((vocab_size,), dtype=torch.float32, device=device)
    ids = list(word_ids)
    if ids:
        v[torch.as_tensor(ids, dtype=torch.long, device=device)] = 1.0
    return v


def sense_vocab_scores(params, cfg: BackpackConfig, target_vec: torch.Tensor,
                       *, chunk: int = 512,
                       eos_id: int = 50256) -> torch.Tensor:
    """score[k, w] = (E C(w)[k] / max_v E C(w)[k]_v) . target for every
    vocabulary word w (JAX :46): the senses from ``bp.sense_table``, their
    (chunk, nv, V) log-distributions ``chunk`` words at a time. -> (nv, V).
    (eos_id: JAX's pad id for its last chunk; no padding here.)"""
    E = iv.embedding_matrix(params["gpt"]).float()
    table = bp.sense_table(params, cfg, chunk)               # (V, nv, d)
    tv = target_vec.to(E.device).float()
    out = []
    for c in table.split(chunk):
        ld = torch.einsum("ckd,vd->ckv", c.float(), E)
        ld = ld / ld.amax(dim=-1, keepdim=True)
        out.append(ld @ tv)                                  # (c, nv)
    return torch.cat(out).T


def _buckets(scores: torch.Tensor, qs: Sequence[float]):
    flat = scores.float().reshape(-1)
    return [iv._quantile(flat, q) for q in qs]


def weights_from_scores(scores: torch.Tensor,
                        quantile_weights: Sequence[float] = (1.4, 1.2, 1.0, 0.8)
                        ) -> torch.Tensor:
    """Bucket (nv, V) scores at their 95/80/60 quantiles into weights (JAX
    :69). -> the (V, nv) table the weighted decode takes."""
    s = scores.float()
    q95, q80, q60 = _buckets(s, (0.95, 0.80, 0.60))
    w = torch.full_like(s, quantile_weights[3])
    w = torch.where((q60 < s) & (s < q80), quantile_weights[2], w)
    w = torch.where((q80 < s) & (s < q95), quantile_weights[1], w)
    w = torch.where(q95 < s, quantile_weights[0], w)
    return w.T


def control_weights(params, cfg: BackpackConfig, word_ids: Sequence[int],
                    strength: int = 1, *, chunk: int = 512):
    """Target words -> (V, nv) weight table and the annealing scale
    max(modifiers) / 7.5 (JAX :86)."""
    modifiers = STRENGTH_MODIFIERS[strength]
    tv = target_vector(word_ids, cfg.padded_vocab_size, _params_device(params))
    scores = sense_vocab_scores(params, cfg, tv, chunk=chunk)
    return weights_from_scores(scores, modifiers), max(modifiers) / 7.5


def _next_tokens(last: torch.Tensor, temperature: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy, or drawn at ``temperature`` from ``generator`` when both are
    given (JAX samples with its key there). -> (b, 1)."""
    if temperature > 0 and generator is not None:
        probs = torch.softmax(last.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
    return last.argmax(dim=-1)[:, None]


@torch.no_grad()
def generate_weighted(params, cfg: BackpackConfig, prompt_ids, table, *,
                      max_new_tokens: int = 64, annealing_scale: float = 0.2,
                      anneal: bool = True, temperature: float = 0.0,
                      generator: Optional[torch.Generator] = None,
                      max_seqlen: Optional[int] = None) -> np.ndarray:
    """Controlled generation with the O(t) annealed decode over a bf16
    cache (JAX :96). prompt_ids (b, p) -> (b, max_new_tokens) token ids."""
    dev = _params_device(params)
    prompt = _on_device(prompt_ids, dev, torch.long)
    b, p = prompt.shape
    S = max_seqlen or (p + max_new_tokens)
    table = _on_device(table, dev, torch.float32)
    cache = bp.init_backpack_cache(cfg, b, S, torch.bfloat16, device=dev)
    state = iv.init_weighted_decode_state(cfg, b, S, device=dev)
    kw = dict(anneal=anneal, annealing_scale=annealing_scale)
    logits, cache, state = iv.weighted_decode_step(params, cfg, prompt, cache,
                                                   state, table, **kw)
    out = []
    for i in range(max_new_tokens):
        tok = _next_tokens(logits[:, -1], temperature, generator)
        out.append(tok)
        if i < max_new_tokens - 1:
            logits, cache, state = iv.weighted_decode_step(
                params, cfg, tok, cache, state, table, **kw)
    return torch.cat(out, dim=1).cpu().numpy().astype(np.int32)


def run_control_experiment(params, cfg: BackpackConfig,
                           word_ids: Sequence[int], prompt_ids, *,
                           strengths: Sequence[int] = (0, 1, 2, 3),
                           max_new_tokens: int = 32,
                           scorer: Optional[Callable] = None,
                           chunk: int = 512) -> Dict[int, Dict]:
    """For each strength: weights, generations, and scorer(generations (b,
    n) ids) -> metrics when a scorer is given (JAX :133)."""
    results = {}
    for strength in strengths:
        table, ann = control_weights(params, cfg, word_ids, strength,
                                     chunk=chunk)
        gens = generate_weighted(params, cfg, prompt_ids, table,
                                 annealing_scale=ann, anneal=strength > 0,
                                 max_new_tokens=max_new_tokens)
        entry: Dict = {"generations": gens}
        if scorer is not None:
            entry["metrics"] = scorer(gens)
        results[strength] = entry
    return results


# ------------------------------------------------------------- introspection

def top_vocab_per_sense(params, cfg: BackpackConfig, word_id: int,
                        k: int = 10):
    """Top-k and bottom-k vocabulary items of each sense of ``word_id`` (JAX
    :165): sense -> {top_ids, top_scores, bottom_ids, bottom_scores}."""
    senses = iv.senses_of_word(params, cfg, word_id)
    logits = iv.per_sense_logits(params, cfg, senses).cpu().numpy()
    out = {}
    for s in range(cfg.num_senses):
        order = np.argsort(logits[s])
        out[s] = {
            "top_ids": order[::-1][:k].tolist(),
            "top_scores": logits[s][order[::-1][:k]].tolist(),
            "bottom_ids": order[:k].tolist(),
            "bottom_scores": logits[s][order[:k]].tolist(),
        }
    return out
