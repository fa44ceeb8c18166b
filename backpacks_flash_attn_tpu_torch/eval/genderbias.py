"""Gender-bias reduction experiment (PyTorch port).

Port of ``backpacks_flash_attn_tpu/eval/genderbias.py``: for career-noun
prompts ending just before a pronoun, the he/she probability ratio, reduced
by scaling sense ``sense_index``'s contextualization at the career nouns
(``interventions.counterfactual_forward``) or, as the baseline, by
projecting the gender direction out of the embedding; ``percent`` fitted by
Nelder-Mead, and the side-effect divergence of the rest of the
distribution. Prompts arrive as token ids.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..config import BackpackConfig
from ..models import backpack as bp
from ..models import interventions as iv
from .control import _params_device


def _ids(params, prompt_ids) -> torch.Tensor:
    return torch.as_tensor(list(prompt_ids), dtype=torch.long,
                           device=_params_device(params))


@torch.no_grad()
def pronoun_logits(params, cfg: BackpackConfig, prompt_ids: Sequence[int], *,
                   job_ids: Sequence[int], sense_index: int = 10,
                   percent: float = 1.0) -> torch.Tensor:
    """Next-token logits with sense ``sense_index``'s contextualization at
    the career-noun positions scaled by ``percent`` (JAX :29)."""
    logits = iv.counterfactual_forward(
        params, cfg, _ids(params, prompt_ids)[None], _ids(params, job_ids),
        sense_index, percent)
    return logits[0, -1]


def bias_score(params, cfg: BackpackConfig, prompts: Sequence[Sequence[int]],
               *, him_id: int, her_id: int, job_ids: Sequence[int],
               sense_index: int = 10, percent: float = 1.0,
               regularize: float = 0.0) -> float:
    """Mean over prompts of max(p(he)/p(she), p(she)/p(he)) at the pronoun
    slot, plus regularize |1 - percent| (JAX :45). 1.0 is unbiased."""
    total = 0.0
    for p in prompts:
        lg = pronoun_logits(params, cfg, p, job_ids=job_ids,
                            sense_index=sense_index, percent=percent)
        probs = torch.softmax(lg.float(), dim=-1)
        him, her = float(probs[him_id]), float(probs[her_id])
        total += max(him / max(her, 1e-20), her / max(him, 1e-20))
    return total / len(prompts) + regularize * abs(1.0 - percent)


def divergence(params, cfg: BackpackConfig, prompts: Sequence[Sequence[int]],
               *, him_id: int, her_id: int, job_ids: Sequence[int],
               sense_index: int = 10, percent: float = 1.0) -> float:
    """Mean |log p_modified - log p_original| over the vocabulary, the
    pronouns left out, averaged over prompts (JAX :62)."""
    total = 0.0
    for p in prompts:
        kw = dict(job_ids=job_ids, sense_index=sense_index)
        mod = torch.log_softmax(pronoun_logits(
            params, cfg, p, percent=percent, **kw).float(), dim=-1)
        orig = torch.log_softmax(pronoun_logits(
            params, cfg, p, percent=1.0, **kw).float(), dim=-1)
        ratio = (mod - orig).abs().cpu().numpy()
        ratio[[him_id, her_id]] = 0.0
        total += float(ratio.mean())
    return total / len(prompts)


def estimate_percent(params, cfg: BackpackConfig,
                     prompts: Sequence[Sequence[int]], *, him_id: int,
                     her_id: int, job_ids: Sequence[int],
                     sense_index: int = 10, maxiter: int = 25) -> float:
    """Nelder-Mead over the regularized bias objective (JAX :84)."""
    from scipy.optimize import minimize

    def fn(x):
        return bias_score(params, cfg, prompts, him_id=him_id, her_id=her_id,
                          job_ids=job_ids, sense_index=sense_index,
                          percent=float(x[0]), regularize=1.0)

    res = minimize(fn, [1.0], method="Nelder-Mead",
                   options={"maxiter": maxiter})
    return float(res.x[0])


def run_genderbias_experiment(params, cfg: BackpackConfig,
                              train_prompts: Sequence[Sequence[int]],
                              test_prompts: Sequence[Sequence[int]], *,
                              him_id: int, her_id: int,
                              job_ids: Sequence[int], sense_index: int = 10,
                              maxiter: int = 25) -> Dict[str, float]:
    """Fit ``percent`` on the train prompts; bias before and after and the
    divergence on the test prompts (JAX :106)."""
    kw = dict(him_id=him_id, her_id=her_id, job_ids=job_ids,
              sense_index=sense_index)
    percent = estimate_percent(params, cfg, train_prompts, maxiter=maxiter,
                               **kw)
    return {
        "percent": percent,
        "bias_before": bias_score(params, cfg, test_prompts, percent=1.0,
                                  **kw),
        "bias_after": bias_score(params, cfg, test_prompts, percent=percent,
                                 **kw),
        "divergence": divergence(params, cfg, test_prompts, percent=percent,
                                 **kw),
    }


@torch.no_grad()
def baseline_projection_logits(params, cfg: BackpackConfig,
                               prompt_ids: Sequence[int], *, him_id: int,
                               her_id: int, percent: float) -> torch.Tensor:
    """The non-Backpack baseline: the (she - he) direction shrunk by (1 -
    percent) in every embedding row, then the plain forward (JAX :127)."""
    E = iv.embedding_matrix(params["gpt"])
    fixed = iv.project_out_embeddings(E, E[her_id] - E[him_id], percent)
    patched = dict(params)
    patched["gpt"] = dict(params["gpt"], wte=fixed)
    return bp.backpack_forward(patched, cfg,
                               _ids(params, prompt_ids)[None])[0, -1]
