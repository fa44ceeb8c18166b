"""Lexical-similarity evaluation (SimLex-999, SimVerb-3500, RG65, WS353),
PyTorch port.

Port of ``backpacks_flash_attn_tpu/eval/similarity.py``: word-pair datasets
with gold scores, per-word vectors from the tied softmax embedding or the
Backpack sense vectors, a family of cosine measures, and the Spearman
correlation against the gold scores. The datasets are files the caller
supplies; the tokenizer is any callable returning {'input_ids': [...]}.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class WordPair:
    word1: str
    word2: str
    gold_score: float


# ------------------------------------------------------------- data loaders
# (formats per run_simlex.py:53-105)

def load_delimited(path: str, *, delimiter: str = ";", skip_first: bool = False,
                   score_col: int = 2) -> List[WordPair]:
    out = []
    with open(path) as fin:
        for i, line in enumerate(fin):
            if i == 0 and skip_first:
                continue
            cols = [c.strip() for c in line.split(delimiter)]
            out.append(WordPair(cols[0], cols[1], float(cols[score_col])))
    return out


def load_rg65(path: str) -> List[WordPair]:
    return load_delimited(path, delimiter=";")


def load_ws353(path: str) -> List[WordPair]:
    return load_delimited(path, delimiter=",", skip_first=True)


def load_simlex999(path: str) -> List[WordPair]:
    return load_delimited(path, delimiter="\t", skip_first=True, score_col=3)


def load_simverb3500(path: str) -> List[WordPair]:
    return load_delimited(path, delimiter="\t", score_col=3)


# ------------------------------------------------------------- word vectors

def mogrify_word(word: str) -> str:
    """GPT-2 BPE: prepend a space so the word is a word, not a suffix
    (run_simlex.py:108-117)."""
    return " " + word


def softmax_vecs(params, words: Sequence[str], tokenizer, *,
                 use_first: bool = False) -> Dict[str, np.ndarray]:
    """Tied-embedding rows per word, averaging subword pieces unless
    use_first (run_simlex.py:137-161)."""
    from ..models.interventions import embedding_matrix
    E = embedding_matrix(params["gpt"]).float().cpu().numpy()
    out = {}
    for w in words:
        ids = tokenizer(mogrify_word(w))["input_ids"]
        if use_first:
            ids = ids[:1]
        out[w] = E[np.asarray(ids)].mean(0)
    return out


def sense_vecs(params, cfg, words: Sequence[str], tokenizer, *,
               use_first: bool = False) -> Dict[str, np.ndarray]:
    """(nv, d) sense vectors per word via the content network, averaging over
    subword pieces (run_simlex.py:164-187). One batched content pass over all
    unique subword ids — valid by the per-token property of the sense net."""
    from ..models import backpack as bp
    from .control import _params_device
    all_ids = {}
    for w in words:
        ids = tokenizer(mogrify_word(w))["input_ids"]
        all_ids[w] = ids[:1] if use_first else ids
    uniq = sorted({i for ids in all_ids.values() for i in ids})
    idx_of = {t: i for i, t in enumerate(uniq)}
    ids = torch.as_tensor([uniq], dtype=torch.long,
                          device=_params_device(params))
    with torch.no_grad():
        senses = bp.content_forward(params, cfg, ids)[0].float().cpu().numpy()
    return {w: senses[[idx_of[t] for t in ids]].mean(0)
            for w, ids in all_ids.items()}


# ------------------------------------------------------------- similarity fns
# (run_simlex.py:189-240)

def flat_cosine(v1: np.ndarray, v2: np.ndarray) -> float:
    a, b = v1.reshape(-1), v2.reshape(-1)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _all_cosines(v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    dots = v1 @ v2.T
    norms = np.outer(np.linalg.norm(v1, axis=-1), np.linalg.norm(v2, axis=-1))
    return dots / norms


def min_pairwise_cosines(v1, v2) -> float:
    return float(np.diagonal(_all_cosines(v1, v2)).min())


def max_pairwise_cosines(v1, v2) -> float:
    return float(np.diagonal(_all_cosines(v1, v2)).max())


def min_all_cosines(v1, v2) -> float:
    return float(_all_cosines(v1, v2).min())


def max_all_cosines(v1, v2) -> float:
    return float(_all_cosines(v1, v2).max())


def sense_cosine(v1, v2, k: int) -> float:
    return flat_cosine(v1[k], v2[k])


def similarity_fns(num_senses: Optional[int] = None,
                   multivec: bool = False) -> Dict[str, Callable]:
    fns: Dict[str, Callable] = {"Cos": flat_cosine}
    if multivec:
        fns.update(MinPair=min_pairwise_cosines, MaxPair=max_pairwise_cosines,
                   MinAll=min_all_cosines, MaxAll=max_all_cosines)
        for k in range(num_senses or 0):
            fns[f"CosSense{k}"] = (lambda a, b, k=k: sense_cosine(a, b, k))
    return fns


# ------------------------------------------------------------- evaluation

def spearman(a: Sequence[float], b: Sequence[float]) -> float:
    """Spearman rank correlation (scipy-free; ties get average ranks)."""
    def rank(x):
        x = np.asarray(x, np.float64)
        order = np.argsort(x, kind="stable")
        r = np.empty_like(x)
        r[order] = np.arange(len(x), dtype=np.float64)
        # average ranks for ties
        for v in np.unique(x):
            m = x == v
            r[m] = r[m].mean()
        return r
    ra, rb = rank(a), rank(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra ** 2).sum() * (rb ** 2).sum())
    return float((ra * rb).sum() / denom) if denom else 0.0


def evaluate_pairs(pairs: Sequence[WordPair],
                   vecs: Dict[str, np.ndarray],
                   sim_fn: Callable) -> Dict[str, float]:
    """Spearman of sim_fn scores vs gold over pairs whose words have vectors
    (run_simlex.py:246-271)."""
    usable = [p for p in pairs if p.word1 in vecs and p.word2 in vecs]
    preds = [sim_fn(vecs[p.word1], vecs[p.word2]) for p in usable]
    gold = [p.gold_score for p in usable]
    return {"spearmanr": spearman(gold, preds), "n": len(usable)}


def evaluate_all(datasets: Dict[str, Sequence[WordPair]],
                 vecs: Dict[str, np.ndarray],
                 fns: Dict[str, Callable]) -> Dict[str, Dict[str, Dict]]:
    return {dname: {fname: evaluate_pairs(pairs, vecs, fn)
                    for fname, fn in fns.items()}
            for dname, pairs in datasets.items()}
