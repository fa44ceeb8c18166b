"""Sense-vector interventions for Backpack LMs (PyTorch port).

Port of ``backpacks_flash_attn_tpu/models/interventions.py``: every
intervention of the Backpack paper is a function over the functional
parameter tree.

  * soft_sense_mask / annealing_scores: multiplicative per-(token, sense)
    weights, annealed toward 1 as a sense is already present in the
    sequence
  * weighted_forward: topic control (sense reweighting)
  * negative_weighted_forward: toxicity removal by mixing per-sense logits,
    the (b, nv, s, V) tensor processed in key-position chunks
  * replaced_word_forward / mogrify_word / project_out_and_in: sense edits
    (knowledge editing); counterfactual_forward and project_out_embeddings:
    the gender-bias experiment and its baseline
  * senses_of_word / per_sense_logits: introspection

Incremental decode: ``weighted_decode_step`` and ``negative_decode_step``
keep the annealing statistics (and the negative mode's sparse
bottom-quantile logits) per cached position, so an intervened decode step
costs O(t) as a plain one does. Their states, like ``BackpackCache``, are
updated IN PLACE; each step's docstring says what it writes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import BackpackConfig
from ..ops import _build
from ..ops.attention import MASK_VALUE
from . import backpack as bp
from . import gpt as gpt_lib

Params = Dict[str, Any]

# f32 bytes of one chunk of the eager intermediates (the dequantized senses
# of the annealing columns, the negative correction's (b, s, C, nv, m)
# products), and the most copies of the vocabulary row the correction's
# scatter spreads over
_CHUNK_BYTES = 256 << 20
_CORRECTION_COPIES = 16


# ------------------------------------------------------------- embeddings

def embedding_matrix(gpt_params: Params) -> torch.Tensor:
    """The (padded) (V, d) tied embedding/unembedding matrix, dequantized
    to bf16 when the tree's embedding is INT8 row-quantized (JAX :56)."""
    wte = gpt_params["wte"]
    if isinstance(wte, dict):
        return (wte["q"].float() * wte["row_scale"]).to(torch.bfloat16)
    return wte


def _quantile(x: torch.Tensor, q: float, dim: int = -1,
              keepdim: bool = False) -> torch.Tensor:
    """``jnp.quantile(x, q, axis=dim)`` (linear interpolation, the position
    q (n - 1) computed in f32 as JAX does) without torch.quantile's input
    size cap: the two order statistics by kthvalue."""
    n = x.shape[dim]
    pos = np.float32(q) * np.float32(n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    hw = np.float32(pos - np.float32(lo))
    v_lo = torch.kthvalue(x, lo + 1, dim=dim, keepdim=keepdim).values
    v_hi = (v_lo if hi == lo
            else torch.kthvalue(x, hi + 1, dim=dim, keepdim=keepdim).values)
    return v_lo * float(np.float32(1) - hw) + v_hi * float(hw)


# ------------------------------------------------------------- sense masks

def soft_sense_mask(content_weights: torch.Tensor, input_ids: torch.Tensor,
                    scores: torch.Tensor) -> torch.Tensor:
    """w[x] * score + (1 - score) (JAX :68): content_weights (V, nv),
    input_ids (b, s), scores (b, s, nv) -> (b, s, nv)."""
    w = content_weights[input_ids]
    return w * scores + (1.0 - scores)


def annealing_scores(E: torch.Tensor, input_ids: torch.Tensor,
                     content: torch.Tensor, *, annealing_scale: float = 0.1,
                     upweight_nearby: bool = True) -> torch.Tensor:
    """Per-(position, sense) annealing scores (JAX :81): sigmoid(6 - scale *
    sum_t relu(C(x_j)[k] . E[x_t])), times 1 + j / 100 when upweight_nearby.
    E (V, d), content (b, s, nv, d) -> (b, s, nv)."""
    s = input_ids.shape[1]
    tok_emb = E[input_ids].float()                              # (b, s, d)
    sims = torch.einsum("bjkd,btd->bjkt", content.float(), tok_emb)
    scores = torch.sigmoid(-annealing_scale * sims.clamp_min(0.0).sum(-1)
                           + 6.0)
    if upweight_nearby:
        scores = scores * (1.0 + torch.arange(s, device=scores.device)
                           / 100.0)[None, :, None]
    return scores


def _resolved_scores(params: Params, cfg: BackpackConfig, input_ids, content,
                     anneal: bool, annealing_scale: float,
                     upweight_nearby: bool) -> torch.Tensor:
    if anneal:
        return annealing_scores(embedding_matrix(params["gpt"]), input_ids,
                                content, annealing_scale=annealing_scale,
                                upweight_nearby=upweight_nearby)
    b, s = input_ids.shape
    return torch.ones((b, s, cfg.num_senses), dtype=torch.float32,
                      device=input_ids.device)


# ------------------------------------------------------------- forwards

def weighted_forward(params: Params, cfg: BackpackConfig,
                     input_ids: torch.Tensor, content_weights: torch.Tensor,
                     *, anneal: bool = True, annealing_scale: float = 0.1,
                     upweight_nearby: bool = True,
                     fused_ctx: Optional[bool] = None) -> torch.Tensor:
    """Topic control (JAX :119): per-(token, sense) multiplicative weights
    with sigmoid annealing on the sense vectors. -> logits (b, s, V).
    fused_ctx picks the combine route as in ``backpack_forward`` (K4 by
    default)."""
    content = bp.content_forward(params, cfg, input_ids)
    scores = _resolved_scores(params, cfg, input_ids, content, anneal,
                              annealing_scale, upweight_nearby)
    weights = soft_sense_mask(content_weights, input_ids, scores)
    return bp.backpack_forward(params, cfg, input_ids, sense_weights=weights,
                               fused_ctx=fused_ctx)


def negative_weighted_forward(params: Params, cfg: BackpackConfig,
                              input_ids: torch.Tensor,
                              content_weights: torch.Tensor, *,
                              anneal: bool = True,
                              annealing_scale: float = 0.1,
                              upweight_nearby: bool = True,
                              quantile: float = 0.02,
                              key_chunk: int = 64) -> torch.Tensor:
    """Toxicity removal (JAX :136): per-sense logits cl = C(x_j)[k] @ E^T,
    wcl = w[k, j] cl, mixed = where(wcl < quantile_V(wcl), wcl, cl), and
    logits_t = sum_k alpha[k, t, :] @ mixed[k]. The contraction runs over
    key chunks of ``key_chunk`` positions, so (b, nv, s, V) never exists.
    -> f32 logits (b, s, V)."""
    _, parts = bp.backpack_forward(params, cfg, input_ids, return_parts=True)
    alpha, content = parts["alpha"], parts["content"]   # (b,nv,s,s), (b,s,nv,d)
    scores = _resolved_scores(params, cfg, input_ids, content, anneal,
                              annealing_scale, upweight_nearby)
    weights = soft_sense_mask(content_weights, input_ids, scores)
    E = embedding_matrix(params["gpt"]).float()
    b, s = input_ids.shape
    acc = torch.zeros((b, s, E.shape[0]), dtype=torch.float32,
                      device=input_ids.device)
    for j0 in range(0, s, key_chunk):
        j1 = min(j0 + key_chunk, s)
        cl = torch.einsum("bjkd,vd->bkjv", content[:, j0:j1].float(), E)
        wcl = weights[:, j0:j1].permute(0, 2, 1)[..., None] * cl
        mixed = torch.where(wcl < _quantile(wcl, quantile, keepdim=True), wcl,
                            cl)
        acc += torch.einsum("bktj,bkjv->btv", alpha[..., j0:j1].float(),
                            mixed)
    return acc


def replaced_word_forward(params: Params, cfg: BackpackConfig,
                          input_ids: torch.Tensor, edited_ids: torch.Tensor,
                          edited_senses: torch.Tensor, *,
                          fused_ctx: Optional[bool] = None) -> torch.Tensor:
    """Knowledge editing (JAX :197): the chosen words' sense vectors
    swapped for edited_senses (m, nv, d)."""
    return bp.backpack_forward(params, cfg, input_ids,
                               sense_edit=(edited_ids, edited_senses),
                               fused_ctx=fused_ctx)


def counterfactual_forward(params: Params, cfg: BackpackConfig,
                           input_ids: torch.Tensor, word_ids: torch.Tensor,
                           sense_index: int, percent: float) -> torch.Tensor:
    """Alpha's columns of sense ``sense_index`` scaled by ``percent`` where
    the key token is in word_ids (m,) (JAX :210, the gender-bias knob)."""
    _, parts = bp.backpack_forward(params, cfg, input_ids, return_parts=True)
    alpha, content = parts["alpha"], parts["content"]
    hit = (input_ids[..., None] == word_ids.to(input_ids.device)[None, None]
           ).any(-1)                                          # (b, s) keys
    col = torch.where(hit, percent, 1.0).to(alpha.dtype)
    alpha = alpha.clone()
    alpha[:, sense_index] *= col[:, None, :]
    outputs = torch.einsum("bkts,bskd->btd", alpha.float(),
                           content.to(alpha.dtype).float())
    return gpt_lib.lm_logits(params["gpt"], cfg, outputs.to(content.dtype))


# ------------------------------------------------------------- sense surgery

def senses_of_word(params: Params, cfg: BackpackConfig,
                   word_id) -> torch.Tensor:
    """(nv, d) sense vectors of one token: a one-token content pass (the
    sense network is per-token; JAX :233)."""
    dev = params["gpt"]["ln_0"]["weight"].device
    ids = torch.as_tensor(word_id, dtype=torch.long, device=dev).reshape(1, 1)
    return bp.content_forward(params, cfg, ids)[0, 0]


def project_out_and_in(senses: torch.Tensor, out_direction: torch.Tensor,
                       in_direction: torch.Tensor) -> torch.Tensor:
    """Each sense's component along out_direction removed and the
    norm-corrected one along in_direction added (JAX :242). senses (nv, d)
    -> f32 (nv, d)."""
    senses = senses.float()
    out_d, in_d = out_direction.float(), in_direction.float()
    dots = senses @ out_d / (out_d @ out_d)
    norm = (out_d @ out_d) / (in_d @ in_d)
    return (senses - dots[:, None] * out_d[None]
            + dots[:, None] * in_d[None] * norm)


def project_out_embeddings(E: torch.Tensor, direction: torch.Tensor,
                           percent: float,
                           word_ids: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The direction's component of E's rows shrunk by (1 - percent), only
    in word_ids' rows when given (JAX :256, the gender-debias baseline)."""
    E32 = E.float()
    d = direction.float()
    dots = E32 @ d / (d @ d)
    fixed = E32 - (1.0 - percent) * dots[:, None] * d[None]
    if word_ids is not None:
        mask = torch.zeros((E.shape[0],), dtype=torch.bool, device=E.device)
        mask[torch.as_tensor(word_ids, device=E.device).long()] = True
        fixed = torch.where(mask[:, None], fixed, E32)
    return fixed.to(E.dtype)


def mogrify_word(params: Params, cfg: BackpackConfig, word_id: int,
                 out_word_id: int, in_word_id: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(edited_ids (1,), edited_senses (1, nv, d)): word_id's senses
    projected from out_word_id's embedding to in_word_id's (JAX :272), for
    replaced_word_forward / backpack_forward(sense_edit=...)."""
    E = embedding_matrix(params["gpt"])
    senses = senses_of_word(params, cfg, word_id)
    fixed = project_out_and_in(senses, E[out_word_id], E[in_word_id])
    return (torch.tensor([word_id], dtype=torch.long, device=senses.device),
            fixed[None].to(senses.dtype))


# ------------------------------------------------------------- introspection

def per_sense_logits(params: Params, cfg: BackpackConfig,
                     senses: torch.Tensor) -> torch.Tensor:
    """E @ C(x)[k] (JAX :288): senses (..., d) -> f32 (..., V)."""
    E = embedding_matrix(params["gpt"])
    return senses.float() @ E.float().T


# ------------------------------------------------------------- incremental
# intervened decode

@dataclasses.dataclass
class WeightedDecodeState:
    """Running annealing statistics of an O(t)-a-step weighted decode (JAX
    :301): sums[b, j, k] = sum_{j' <= t} relu(C(x_j)[k] . E[x_{j'}]), grown
    by one relu'd rank-1 update a new token; tok_emb holds the embedding
    rows of the tokens so far, token_ids the tokens."""
    sums: torch.Tensor       # (b, max_s, nv) f32
    tok_emb: torch.Tensor    # (b, max_s, d)
    token_ids: torch.Tensor  # (b, max_s) int64


def init_weighted_decode_state(cfg: BackpackConfig, batch: int,
                               max_seqlen: int, dtype=torch.bfloat16,
                               device="cuda") -> WeightedDecodeState:
    device = _build.resolve_device(device)
    return WeightedDecodeState(
        sums=torch.zeros((batch, max_seqlen, cfg.num_senses),
                         dtype=torch.float32, device=device),
        tok_emb=torch.zeros((batch, max_seqlen, cfg.n_embd), dtype=dtype,
                            device=device),
        token_ids=torch.zeros((batch, max_seqlen), dtype=torch.long,
                              device=device))


def _put_row(big: torch.Tensor, small: torch.Tensor, slot: int) -> None:
    big[slot:slot + 1] = small.to(big.dtype)


def insert_state_slot(big: WeightedDecodeState, small: WeightedDecodeState,
                      slot: int) -> WeightedDecodeState:
    """Copy a batch-1 state into row ``slot`` of ``big``, in place (JAX
    :324, the analogue of bp.insert_cache_slot); returns ``big``."""
    for f in dataclasses.fields(WeightedDecodeState):
        _put_row(getattr(big, f.name), getattr(small, f.name), slot)
    return big


def _content_columns(cache: bp.BackpackCache, e_new: torch.Tensor, nv: int,
                     W: int) -> torch.Tensor:
    """sum_t relu(C(x_j)[k] . e_new[b, t]) over the cached senses' first W
    positions -> (b, W, nv) f32. The cache is read as JAX's
    ``_dequant_content_cache`` (:336) reads it: INT8 senses dequantized to
    bf16, then f32; a slice of slots at a time, so at most ~256 MB of f32
    senses exist at once."""
    b, s, d = e_new.shape
    n = max(1, min(b, _CHUNK_BYTES // max(1, nv * W * d * 4)))
    out = []
    for b0 in range(0, b, n):
        b1 = min(b0 + n, b)
        rows = slice(b0 * nv, b1 * nv)
        c = cache.content[rows, :W]
        if cache.quantized:
            c = (c.float() * cache.content_scale[rows, :W, None]).to(
                torch.bfloat16)
        c = c.float().reshape(b1 - b0, nv * W, d)
        col = torch.bmm(c, e_new[b0:b1].float().transpose(1, 2))
        out.append(col.clamp_min_(0.0).sum(-1).reshape(b1 - b0, nv, W))
    return torch.cat(out).transpose(1, 2)


def _check_cache(cache: bp.BackpackCache, what: str) -> None:
    if cache.bits == 4:
        raise NotImplementedError(
            f"{what} reads the sense cache (and the negative step the ctx-K "
            "cache) position by position, which the mixed int4 cache (bits "
            "4) packs in pairs; JAX computes this only over bf16, f32 and "
            "INT8 caches. Use an INT8 cache, or anneal=False for the "
            "weighted decode")
    if cache.staged:
        raise ValueError(f"{what} takes an unstaged cache: flush it and step "
                         "its plain view (the serving engine's)")


def advance_weighted_state(params: Params, cfg: BackpackConfig,
                           input_ids: torch.Tensor, cache: bp.BackpackCache,
                           state: WeightedDecodeState,
                           content_weights: torch.Tensor, *,
                           anneal: bool = True, annealing_scale: float = 0.1,
                           upweight_nearby: bool = True,
                           token_mask: Optional[torch.Tensor] = None,
                           window: Optional[int] = None
                           ) -> Tuple[WeightedDecodeState, torch.Tensor]:
    """Advance the annealing statistics over input_ids (b, s) at the
    cache's lengths (an int or (b,) per slot; the cache is read, not
    written) and return (state, weights (b, max_s, nv)) (JAX :344). Writes
    ``state`` in place: token_ids and tok_emb at the new positions; with
    anneal, sums gains the new tokens' columns at every cached position
    and its rows at the new positions. token_mask (b, s): False marks
    bucket padding, whose embeddings add nothing. window: the caller's
    bound on length + s; only that prefix is read (JAX reads the whole
    cache; the columns past it are masked there)."""
    b, s = input_ids.shape
    offset = cache.length
    vec = isinstance(offset, torch.Tensor)
    max_s = state.sums.shape[1]
    W = max_s if window is None else min(window, max_s)
    E = embedding_matrix(params["gpt"])
    dev = input_ids.device

    e_new = E[input_ids]                                      # (b, s, d)
    if token_mask is not None:
        # zeroed pad embeddings add relu(c . 0) = 0 everywhere
        e_new = e_new * token_mask[..., None].to(e_new.dtype)
    gpt_lib.update_rows_axis(state.token_ids, input_ids, offset, axis=1)
    gpt_lib.update_rows_axis(state.tok_emb, e_new.to(state.tok_emb.dtype),
                             offset, axis=1)
    if anneal:
        _check_cache(cache, "the annealed weighted decode")
        nv = cfg.num_senses
        # (1) new columns: every cached position j < offset gains
        #     relu(C(x_j) . E[x_t]) for each new token t (none at offset 0)
        if vec or offset > 0:
            col = _content_columns(cache, e_new, nv, W)          # (b, W, nv)
            jpos = torch.arange(W, device=dev)[None, :]
            off_col = offset[:, None] if vec else offset
            state.sums[:, :W] += torch.where((jpos < off_col)[..., None], col,
                                             0.0)
        # (2) new rows: position t sums relu(C(x_t) . E[x_j']) over every
        #     j' <= offset + s - 1, the other new tokens included
        c_new = bp.content_forward(params, cfg, input_ids)       # (b, s, nv, d)
        row = torch.einsum("btkd,bjd->btkj", c_new.float(),
                           state.tok_emb[:, :W].float()).clamp_min_(0.0)
        lim = (offset[:, None] if vec else offset) + s
        valid = torch.arange(W, device=dev)[None, :] < lim
        row = torch.where(valid[:, None, None, :], row, 0.0).sum(-1)
        gpt_lib.update_rows_axis(state.sums, row, offset, axis=1)
        scores = torch.sigmoid(-annealing_scale * state.sums + 6.0)
        if upweight_nearby:
            scores = scores * (1.0 + torch.arange(max_s, device=dev)
                               / 100.0)[None, :, None]
    else:
        scores = torch.ones((b, max_s, cfg.num_senses), dtype=torch.float32,
                            device=dev)
    weights = soft_sense_mask(content_weights, state.token_ids, scores)
    return state, weights


@dataclasses.dataclass
class NegativeDecodeState:
    """State of an O(t)-a-step negative-weighted (toxicity-removal) decode
    (JAX :408). The full forward mixes per-sense logits,

        mixed[k, j, v] = wcl if wcl[k, j, v] < quantile_V(wcl[k, j, :]) else cl
        logits[t]      = sum_k alpha[k, t, :] @ mixed[k]

    with cl = C(x_j)[k] @ E^T and wcl = w[k, j] cl. The annealed weight is
    a positive scalar over the vocabulary, so {wcl < quantile(wcl)} equals
    {cl < quantile(cl)}: the suppressed set of a (position, sense) does not
    depend on w and is fixed when the token enters the cache. With
    mixed = cl + (w - 1) cl 1[cl < q_cl],

        logits[t] = plain_logits[t] + sum_k sum_j alpha[k, t, j] (w[k, j] - 1)
                                      clneg[k, j, :]

    where clneg holds the bottom ``quantile`` of the vocabulary (~2%). Exact
    when w > 0 everywhere (every published table is).

    neg_vals/neg_idx (b, S, nv, m): the bottom-m per-sense logits and their
    vocabulary ids; thresh (b, S, nv): the quantile, so that the strict
    ``<`` of the full forward holds entry by entry."""
    weighted: WeightedDecodeState
    neg_vals: torch.Tensor
    neg_idx: torch.Tensor
    thresh: torch.Tensor

    def nbytes(self) -> int:
        """Device bytes of the state, the weighted statistics included."""
        ts = [self.neg_vals, self.neg_idx, self.thresh,
              *(getattr(self.weighted, f.name)
                for f in dataclasses.fields(WeightedDecodeState))]
        return sum(t.numel() * t.element_size() for t in ts)


def negative_m(vocab_size: int, quantile: float) -> int:
    """Entries strictly below a linearly interpolated quantile of n distinct
    values: at most floor(quantile (n - 1)) + 1."""
    return int(quantile * (vocab_size - 1)) + 1


def init_negative_decode_state(cfg: BackpackConfig, batch: int,
                               max_seqlen: int, *, quantile: float = 0.02,
                               device="cuda") -> NegativeDecodeState:
    """Zeros; neg_vals and neg_idx take batch * max_seqlen * nv * m * 4
    bytes each (m = negative_m(padded vocab, quantile): 4.2 GB each at 128
    slots of 512 for backpack-small)."""
    device = _build.resolve_device(device)
    m = negative_m(cfg.padded_vocab_size, quantile)
    shape = (batch, max_seqlen, cfg.num_senses, m)
    return NegativeDecodeState(
        weighted=init_weighted_decode_state(cfg, batch, max_seqlen,
                                            device=device),
        neg_vals=torch.zeros(shape, dtype=torch.float32, device=device),
        neg_idx=torch.zeros(shape, dtype=torch.int32, device=device),
        thresh=torch.zeros(shape[:3], dtype=torch.float32, device=device))


def insert_negative_state_slot(big: NegativeDecodeState,
                               small: NegativeDecodeState,
                               slot: int) -> NegativeDecodeState:
    """insert_state_slot for the negative state (JAX :466), in place."""
    insert_state_slot(big.weighted, small.weighted, slot)
    for name in ("neg_vals", "neg_idx", "thresh"):
        _put_row(getattr(big, name), getattr(small, name), slot)
    return big


def negative_decode_step(params: Params, cfg: BackpackConfig,
                         input_ids: torch.Tensor, cache: bp.BackpackCache,
                         state: NegativeDecodeState,
                         content_weights: torch.Tensor, *,
                         anneal: bool = True, annealing_scale: float = 0.1,
                         upweight_nearby: bool = True, quantile: float = 0.02,
                         negative_mask: Optional[torch.Tensor] = None,
                         sense_weights: Optional[torch.Tensor] = None,
                         token_mask: Optional[torch.Tensor] = None,
                         window: Optional[int] = None,
                         ) -> Tuple[torch.Tensor, bp.BackpackCache,
                                    NegativeDecodeState]:
    """One prefill (s >= 1) or decode (s == 1) step of negative-weighted
    generation at O(t) a step (JAX :479; see NegativeDecodeState). ->
    (f32 logits (b, s, V), cache, state). Writes ``cache`` (as
    backpack_forward_with_cache does) and ``state`` (advance_weighted_state's
    writes, and neg_vals, neg_idx, thresh at the new positions) in place.

    negative_mask (b,): rows with False decode plain (the serving engine's
    per-slot mix; the correction is formed for the True rows only, which
    reads the mask on the host). sense_weights: passed to the plain cached
    forward, for OTHER slots' control sharing the batch (the negative rows'
    own alpha/content stay plain, as in the reference). token_mask (b, s):
    False marks bucket padding. window: the caller's bound on length + s.
    The correction's (b, s, C, nv, m) products are formed C cached
    positions at a time (~256 MB of f32 each) and scattered into the
    vocabulary with ``scatter_add_``, whose order of additions on the card
    varies from run to run."""
    _check_cache(cache, "the negative-weighted decode")
    b, s = input_ids.shape
    offset = cache.length
    vec = isinstance(offset, torch.Tensor)
    E = embedding_matrix(params["gpt"]).float()
    V = E.shape[0]
    m = state.neg_vals.shape[-1]
    nv, dnv = cfg.num_senses, cfg.sense_head_dim
    dnv_pad = cfg.sense_head_dim_padded

    _, weights = advance_weighted_state(
        params, cfg, input_ids, cache, state.weighted, content_weights,
        anneal=anneal, annealing_scale=annealing_scale,
        upweight_nearby=upweight_nearby, token_mask=token_mask,
        window=window)

    # the incoming tokens' sparse bottom-quantile per-sense logits
    c_new = bp.content_forward(params, cfg, input_ids)         # (b, s, nv, d)
    cl = torch.einsum("btkd,vd->btkv", c_new.float(), E)        # (b, s, nv, V)
    pos = np.float32(quantile) * np.float32(V - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    hw = np.float32(pos - np.float32(lo))
    low = torch.topk(cl, max(m, hi + 1), dim=-1, largest=False, sorted=True)
    del cl
    thresh_new = (low.values[..., lo] * float(np.float32(1) - hw)
                  + low.values[..., hi] * float(hw))           # jnp.quantile
    gpt_lib.update_rows_axis(state.neg_vals, low.values[..., :m], offset, 1)
    gpt_lib.update_rows_axis(state.neg_idx, low.indices[..., :m], offset, 1)
    gpt_lib.update_rows_axis(state.thresh, thresh_new, offset, 1)
    del low

    # the plain incremental forward: sum_k alpha @ cl is the plain logits
    logits, cache, q = bp.backpack_forward_with_cache(
        params, cfg, input_ids, cache, sense_weights=sense_weights,
        window=window, return_ctx_q=True)

    # the new rows of alpha against the updated ctx-K cache's window (at a
    # scalar length, its valid prefix: the columns past it get alpha 0)
    max_cache = cache.ctx_k.shape[-1]
    S = max_cache if window is None else min(window, max_cache)
    if not vec:
        S = min(S, offset + s)
    k4 = cache.ctx_k[:, :, :S].reshape(b, nv, dnv_pad, S)
    q_pad = (torch.nn.functional.pad(q, (0, dnv_pad - dnv))
             if dnv_pad != dnv else q)
    q_s = (q_pad.float() * dnv ** -0.5).to(q.dtype)
    scores = torch.einsum("btkd,bkds->bkts", q_s.float(),
                          k4.to(q.dtype).float())
    if cache.quantized:
        scores = scores * cache.ctx_k_scale[:, :S].reshape(b, nv, S)[:, :, None]
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    off_b = offset[:, None, None] if vec else offset
    causal = (kpos[None] <= qpos[None] + off_b).expand(b, s, S)
    alpha = torch.softmax(torch.where(causal[:, None], scores, MASK_VALUE),
                          dim=-1)                               # (b, nv, s, S)

    # the sparse correction sum_j alpha (w - 1) clneg, C positions at a time,
    # over the negative rows only (the others' correction is zero). The
    # bottom sets of one sense overlap across positions, so position j adds
    # into copy j % R of the vocabulary row (fewer atomics on one address),
    # and the R copies are summed at the end.
    w1 = weights[:, :S].float() - 1.0                           # (b, S, nv)
    rows = None if negative_mask is None else negative_mask.nonzero()[:, 0]
    pick = (lambda t: t) if rows is None else (lambda t: t[rows])
    alpha, w1 = pick(alpha), pick(w1)
    n = alpha.shape[0]
    R = max(1, min(_CORRECTION_COPIES,
                   _CHUNK_BYTES // max(1, n * s * V * 4)))
    correction = torch.zeros((n, s, R * V), dtype=torch.float32,
                             device=q.device)
    C = max(1, _CHUNK_BYTES // max(1, n * s * nv * m * 4))
    for j0 in range(0, S if n else 0, C):
        j1 = min(j0 + C, S)
        vals = pick(state.neg_vals[:, j0:j1])
        vals_eff = torch.where(vals < pick(state.thresh[:, j0:j1])[..., None],
                               vals, 0.0)                       # (n, C, nv, m)
        coeff = torch.einsum("bkts,bsk->btsk", alpha[..., j0:j1],
                             w1[:, j0:j1])                      # (n, s, C, nv)
        contrib = coeff[..., None] * vals_eff[:, None]
        copy = torch.arange(j0, j1, device=q.device) % R * V
        idx = pick(state.neg_idx[:, j0:j1]).long() + copy[None, :, None, None]
        correction.scatter_add_(2, idx.reshape(n, 1, -1).expand(n, s, -1),
                                contrib.reshape(n, s, -1))
    correction = correction.view(n, s, R, V).sum(2)
    logits = logits.float()
    if rows is None:
        return logits + correction, cache, state
    logits[rows] += correction
    return logits, cache, state


def weighted_decode_step(params: Params, cfg: BackpackConfig,
                         input_ids: torch.Tensor, cache: bp.BackpackCache,
                         state: WeightedDecodeState,
                         content_weights: torch.Tensor, *,
                         anneal: bool = True, annealing_scale: float = 0.1,
                         upweight_nearby: bool = True
                         ) -> Tuple[torch.Tensor, bp.BackpackCache,
                                    WeightedDecodeState]:
    """One prefill (s >= 1) or decode (s == 1) step of weighted generation
    with the annealing kept incrementally (JAX :583): equals
    weighted_forward's last rows at O(t) a step. -> (logits (b, s, V),
    cache, state); writes ``cache`` and ``state`` in place."""
    state, weights = advance_weighted_state(
        params, cfg, input_ids, cache, state, content_weights,
        anneal=anneal, annealing_scale=annealing_scale,
        upweight_nearby=upweight_nearby)
    logits, cache = bp.backpack_forward_with_cache(
        params, cfg, input_ids, cache, sense_weights=weights)
    return logits, cache, state
