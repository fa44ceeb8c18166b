"""Sense-vector introspection data (PyTorch port).

Port of ``backpacks_flash_attn_tpu/eval/visualize.py``: PCA projections
and cosine-similarity matrices of sense vectors, and each (sense, position)
pair's share of a prediction. The functions return numpy arrays; plotting
stays with the caller.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import BackpackConfig
from ..models import backpack as bp
from ..models import interventions as iv
from .control import _on_device, _params_device


@torch.no_grad()
def sense_matrix(params, cfg: BackpackConfig,
                 word_ids: Sequence[int]) -> np.ndarray:
    """(n_words, nv, d) sense vectors, one batched content pass (JAX :24)."""
    ids = torch.as_tensor(list(word_ids), dtype=torch.long,
                          device=_params_device(params))[None]
    return bp.content_forward(params, cfg, ids)[0].float().cpu().numpy()


def sense_pca(params, cfg: BackpackConfig, word_ids: Sequence[int],
              n_components: int = 2,
              sense: Optional[int] = None) -> Dict[str, np.ndarray]:
    """PCA (plain SVD) of one sense's vectors across words, or of every
    (word, sense) pair (JAX :32): {'projected', 'components', 'explained',
    'mean'}."""
    senses = sense_matrix(params, cfg, word_ids)
    X = (senses[:, sense] if sense is not None
         else senses.reshape(-1, senses.shape[-1]))
    mu = X.mean(0, keepdims=True)
    Xc = X - mu
    _, S, Vt = np.linalg.svd(Xc, full_matrices=False)
    var = (S ** 2) / max(len(X) - 1, 1)
    return {"projected": Xc @ Vt[:n_components].T,
            "components": Vt[:n_components],
            "explained": var[:n_components] / var.sum(), "mean": mu[0]}


def _cosines(v: np.ndarray) -> np.ndarray:
    n = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-10)
    return n @ n.T


def sense_similarity_matrix(params, cfg: BackpackConfig,
                            word_ids: Sequence[int],
                            sense: int) -> np.ndarray:
    """(n_words, n_words) cosine similarity of one sense across words (JAX
    :53)."""
    return _cosines(sense_matrix(params, cfg, word_ids)[:, sense])


@torch.no_grad()
def cross_sense_similarity(params, cfg: BackpackConfig,
                           word_id: int) -> np.ndarray:
    """(nv, nv) cosine similarity between the senses of one word (JAX
    :63)."""
    return _cosines(iv.senses_of_word(params, cfg, word_id).float()
                    .cpu().numpy())


@torch.no_grad()
def localize_prediction(params, cfg: BackpackConfig, input_ids,
                        target_id: int) -> np.ndarray:
    """contrib[k, j] = alpha[k, -1, j] (C(x_j)[k] . E[target]): each (sense,
    position) pair's share of the last position's logit of target_id (JAX
    :71). -> (nv, s); the sum is the logit of the bias-free tied head."""
    ids = _on_device(input_ids, _params_device(params), torch.long)
    if ids.dim() == 1:
        ids = ids[None]
    _, parts = bp.backpack_forward(params, cfg, ids, return_parts=True)
    alpha = parts["alpha"][0].float().cpu().numpy()          # (nv, s, s)
    content = parts["content"][0].float().cpu().numpy()      # (s, nv, d)
    E = iv.embedding_matrix(params["gpt"]).float().cpu().numpy()
    return alpha[:, -1, :] * (content @ E[target_id]).T
