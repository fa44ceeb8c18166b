"""MAUVE (Pillutla et al., 2021): divergence-frontier comparison of model
generations against human text.

Port of ``backpacks_flash_attn_tpu/eval/mauve.py`` (reference:
training/src/run_mauve.py:13-30, which delegates the metric to the HF
`evaluate` mauve module). The pipeline:

  1. featurize: terminal-token hidden state from the port's own GPT or
     Backpack forward on the device (the role GPT-2 plays in the reference
     metric)
  2. quantize: joint l2-normalize -> PCA (keep 90% explained variance) ->
     seeded k-means++ over the union of both feature sets, then per-side
     cluster histograms
  3. divergence curve: for mixtures R = w*P + (1-w)*Q over a w-grid, the
     points (exp(-c*KL(Q||R)), exp(-c*KL(P||R))) with c=5
  4. MAUVE = area under that curve (trapezoid); the symmetric
     frontier integral is also reported

Steps 2-4 are the JAX package's numpy code, copied: feature counts are
O(1000), host work.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch


# ------------------------------------------------------------- featurization

@torch.no_grad()
def featurize_terminal_hidden(params, cfg, token_ids: Sequence[Sequence[int]],
                              *, model: str = "gpt",
                              batch_size: int = 16,
                              max_len: Optional[int] = None) -> np.ndarray:
    """Terminal-token hidden state per text -> (n_texts, d) float32 (JAX
    :36), on the params' device.

    model="gpt" uses gpt_forward's post-final-LN hidden; model="backpack"
    uses the contextual (sense-combined) hidden state (``backpack_forward``
    with ``return_parts``). Texts are right-padded into one (batch_size,
    max_len) shape, as JAX pads to keep one compiled shape; the feature is
    taken at each text's last real token, so padding never leaks into it.
    """
    from ..models import backpack as bp
    from ..models import gpt as gpt_lib

    if max_len is None:
        max_len = min(max(len(t) for t in token_ids), cfg.n_positions)
    dev = (params if model == "gpt" else params["gpt"])["wte"].device

    def fwd(ids):
        if model == "gpt":
            return gpt_lib.gpt_forward(params, cfg, ids)
        _, parts = bp.backpack_forward(params, cfg, ids, return_parts=True)
        return parts["outputs"]   # sense-combined pre-head hidden (b, s, d)

    feats: List[np.ndarray] = []
    for start in range(0, len(token_ids), batch_size):
        chunk = token_ids[start:start + batch_size]
        if len(chunk) < batch_size:  # keep one batch shape
            chunk = list(chunk) + [chunk[-1]] * (batch_size - len(chunk))
        ids = np.zeros((batch_size, max_len), np.int64)
        last = np.zeros((batch_size,), np.int64)
        for i, t in enumerate(chunk):
            t = list(t)[:max_len]
            ids[i, :len(t)] = t
            last[i] = max(len(t) - 1, 0)
        hidden = fwd(torch.from_numpy(ids).to(dev))
        rows = hidden[torch.arange(batch_size, device=dev),
                      torch.from_numpy(last).to(dev)]
        feats.append(rows.float().cpu().numpy())
    return np.concatenate(feats)[:len(token_ids)]


# ------------------------------------------------------------- quantization

def _pca(x: np.ndarray, explained_variance: float) -> np.ndarray:
    """Project centered x onto the top principal components covering
    `explained_variance` of the total variance (mauve's preprocessing)."""
    x = x - x.mean(0, keepdims=True)
    # SVD of the data matrix; singular values give component variances
    _, s, vt = np.linalg.svd(x, full_matrices=False)
    var = s ** 2
    ratio = np.cumsum(var) / max(var.sum(), 1e-12)
    k = int(np.searchsorted(ratio, explained_variance) + 1)
    return x @ vt[:k].T


def _kmeans_once(x: np.ndarray, k: int, rng: np.random.Generator,
                 max_iter: int) -> tuple[np.ndarray, float]:
    n = x.shape[0]
    # k-means++ seeding
    centers = [x[rng.integers(n)]]
    d2 = ((x - centers[0]) ** 2).sum(-1)
    for _ in range(k - 1):
        probs = d2 / max(d2.sum(), 1e-12)
        centers.append(x[rng.choice(n, p=probs)])
        d2 = np.minimum(d2, ((x - centers[-1]) ** 2).sum(-1))
    c = np.stack(centers)
    assign = np.zeros(n, np.int64)
    for _ in range(max_iter):
        dist = ((x[:, None, :] - c[None]) ** 2).sum(-1)
        new_assign = dist.argmin(1)
        if (new_assign == assign).all() and _ > 0:
            break
        assign = new_assign
        for j in range(k):
            mask = assign == j
            if mask.any():
                c[j] = x[mask].mean(0)
            else:  # empty cluster: grab the point farthest from its center
                c[j] = x[dist.min(1).argmax()]
    inertia = float(((x - c[assign]) ** 2).sum())
    return assign, inertia


def cluster_histograms(p_feats: np.ndarray, q_feats: np.ndarray, *,
                       num_buckets="auto", explained_variance: float = 0.9,
                       kmeans_restarts: int = 5, kmeans_max_iter: int = 500,
                       seed: int = 25) -> tuple[np.ndarray, np.ndarray]:
    """Joint quantization of both feature sets -> (p_hist, q_hist) over the
    shared k-means codebook (mauve's cluster_feats)."""
    if num_buckets == "auto":
        num_buckets = max(2, min(len(p_feats), len(q_feats)) // 10)
    joint = np.concatenate([p_feats, q_feats]).astype(np.float64)
    joint /= np.maximum(np.linalg.norm(joint, axis=-1, keepdims=True), 1e-12)
    joint = _pca(joint, explained_variance)
    rng = np.random.default_rng(seed)
    best, best_inertia = None, np.inf
    for _ in range(kmeans_restarts):
        assign, inertia = _kmeans_once(joint, num_buckets, rng,
                                       kmeans_max_iter)
        if inertia < best_inertia:
            best, best_inertia = assign, inertia
    p_hist = np.bincount(best[:len(p_feats)], minlength=num_buckets)
    q_hist = np.bincount(best[len(p_feats):], minlength=num_buckets)
    return (p_hist / p_hist.sum()), (q_hist / q_hist.sum())


# ------------------------------------------------------- divergence frontier

# numpy 2 renamed trapz to trapezoid; older numpy has only trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _kl(a: np.ndarray, b: np.ndarray) -> float:
    mask = a > 0
    return float((a[mask] * (np.log(a[mask]) - np.log(b[mask]))).sum())


def divergence_curve(p_hist: np.ndarray, q_hist: np.ndarray, *,
                     scaling: float = 5.0, size: int = 25) -> np.ndarray:
    """(size+2, 2) points (exp(-c*KL(Q||R)), exp(-c*KL(P||R))) for mixtures
    R = w*P + (1-w)*Q, w on an open grid, plus the (0,1)/(1,0) endpoints."""
    pts = [(0.0, 1.0)]
    for w in np.linspace(0.0, 1.0, size + 2)[1:-1]:
        r = w * p_hist + (1.0 - w) * q_hist
        pts.append((np.exp(-scaling * _kl(q_hist, r)),
                    np.exp(-scaling * _kl(p_hist, r))))
    pts.append((1.0, 0.0))
    return np.asarray(pts)


@dataclasses.dataclass
class MauveResult:
    mauve: float
    frontier_integral: float
    divergence_curve: np.ndarray     # (n, 2)
    p_hist: np.ndarray
    q_hist: np.ndarray
    num_buckets: int


def compute_mauve(p_features: np.ndarray, q_features: np.ndarray, *,
                  num_buckets="auto", explained_variance: float = 0.9,
                  scaling: float = 5.0, curve_size: int = 25,
                  seed: int = 25) -> MauveResult:
    """p = human/reference features, q = model features -> MAUVE in (0, 1]."""
    p_hist, q_hist = cluster_histograms(
        p_features, q_features, num_buckets=num_buckets,
        explained_variance=explained_variance, seed=seed)
    curve = divergence_curve(p_hist, q_hist, scaling=scaling, size=curve_size)
    order = np.argsort(curve[:, 0])
    x, y = curve[order, 0], curve[order, 1]
    mauve_score = float(_trapezoid(y, x))
    # symmetric frontier integral: mean over the mixture grid of
    # 0.5*(KL(P||R) + KL(Q||R)) — the paper's alternative summary
    fi = 0.0
    grid = np.linspace(0.0, 1.0, curve_size + 2)[1:-1]
    for w in grid:
        r = w * p_hist + (1.0 - w) * q_hist
        fi += 0.5 * (_kl(p_hist, r) + _kl(q_hist, r))
    return MauveResult(mauve=mauve_score,
                       frontier_integral=float(fi / len(grid)),
                       divergence_curve=curve, p_hist=p_hist, q_hist=q_hist,
                       num_buckets=len(p_hist))


# ------------------------------------------------------------------ runner

def run_mauve(ref_features: np.ndarray, pred_features: np.ndarray, *,
              seed: int = 0, **kw) -> MauveResult:
    """The reference CLI's contract (run_mauve.py:18-27): when one side has
    more texts, shuffle it with a seeded rng and truncate to the shorter
    length, then compute the metric."""
    rng = np.random.default_rng(seed)
    n = min(len(ref_features), len(pred_features))
    if len(pred_features) > n:
        pred_features = pred_features[rng.permutation(len(pred_features))[:n]]
    if len(ref_features) > n:
        ref_features = ref_features[rng.permutation(len(ref_features))[:n]]
    return compute_mauve(ref_features, pred_features, **kw)
