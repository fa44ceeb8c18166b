"""GPT-2 style decoder (PyTorch port): training forward and inference.

Port of ``backpacks_flash_attn_tpu/models/gpt.py``: pure functions over a
dict of tensors in the JAX tree layout (kernels ``(in, out)``, layers
stacked on a leading ``n_layer`` axis), the reordered residual
("Attn/MLP -> Add -> LN", final LN as the last layer's norm2, first LN
hoisted to ``ln_0``), the f32 residual stream, and the flat-E KV cache
with its per-slot lengths and staging block (serving). Where JAX scans
over layers, the port loops. In training the dropout keys
split as in JAX (``utils.prng``), so every mask is JAX's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..config import GPTConfig
from ..ops import _build, dense, norms, quant, rotary
from ..ops.attention import mha
from ..utils import prng
from ..ops.decode_attention import (decode_attention,
                                    decode_attention_flat_multi,
                                    decode_attention_flat_multi_staged,
                                    decode_attention_int4,
                                    decode_attention_int4_ml,
                                    decode_attention_staged,
                                    merge_softmax_segments,
                                    stage_segment_attention)

Params = Dict[str, Any]

# Multi-token cached steps at or below this width take the flat-layout
# contraction instead of the relayout of the prefill branch.
FLAT_MULTI_MAX = 8


def _softmax_scales(cfg: GPTConfig) -> list:
    """Per-layer softmax scale, f32-rounded as in JAX
    (``scale_attn_by_inverse_layer_idx`` divides by layer index + 1)."""
    scale = cfg.head_dim ** -0.5
    idx = torch.arange(cfg.n_layer, dtype=torch.float32)
    if cfg.scale_attn_by_inverse_layer_idx:
        return (scale / (idx + 1.0)).tolist()
    return torch.full((cfg.n_layer,), scale, dtype=torch.float32).tolist()


def _check_supported(cfg: GPTConfig) -> None:
    if cfg.moe_experts or cfg.attn_dwconv:
        raise NotImplementedError("MoE and dwconv GPT variants are not "
                                  "ported yet (ROADMAP Queue 1 item 7)")


def tree_index(tree, i: int):
    """Layer i of a layer-stacked tree (dicts, tensors, QuantWeights)."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    if isinstance(tree, quant.QuantWeight):
        return dataclasses.replace(
            tree, q=tree.q[i], scale=tree.scale[i],
            bias=None if tree.bias is None else tree.bias[i])
    return tree[i]


# ---------------------------------------------------------------- init

def init_gpt(cfg: GPTConfig, generator: torch.Generator,
             dtype=torch.float32, device="cuda") -> Params:
    """GPT-2-paper init, N(0, 0.02^2) with residual-out projections at
    0.02 / sqrt(2 * n_layer). The numbers differ from JAX's for the same
    seed; tests carry weights across with utils.weights.params_from_numpy."""
    _check_supported(cfg)
    device = _build.resolve_device(device)
    d, v = cfg.n_embd, cfg.padded_vocab_size
    std = cfg.initializer_range
    out_std = std / (2 * cfg.n_layer) ** 0.5
    kw = dict(dtype=dtype, device=device)
    params: Params = {
        "wte": dense._normal(generator, (v, d), std, dtype, device),
        "ln_0": norms.init_layer_norm(d, **kw),
    }
    if cfg.n_positions > 0:
        params["wpe"] = dense._normal(generator, (cfg.n_positions, d), std,
                                      dtype, device)
    layers = [{
        "Wqkv": dense.init_linear(generator, d, 3 * d, std=std, **kw),
        "out_proj": dense.init_linear(generator, d, d, std=out_std, **kw),
        "norm1": norms.init_layer_norm(d, **kw),
        "norm2": norms.init_layer_norm(d, **kw),
        "mlp": dense.init_mlp(generator, d, cfg.inner_dim, std=std,
                              out_std=out_std, **kw),
    } for _ in range(cfg.n_layer)]
    params["layers"] = _stack(layers)
    return params


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# ---------------------------------------------------------------- embedding

def quant_act_dtype(params: Params):
    """Activation dtype of a quantized tree: that of its ``wpe`` (which
    ``quantize_gpt_params`` casts to ``act_dtype``), else bf16 as in JAX."""
    return params["wpe"].dtype if "wpe" in params else torch.bfloat16


def take_embedding(wte, input_ids: torch.Tensor,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """Embedding gather; wte is a (V, d) tensor or an INT8 row-quantized
    dict {'q': (V, d) int8, 'row_scale': (V, 1)}, dequantized to dtype."""
    if isinstance(wte, dict):
        rows = wte["q"][input_ids].float()
        return (rows * wte["row_scale"][input_ids]).to(dtype)
    return wte[input_ids]


def vocab_rows(wte_local, input_ids: torch.Tensor, shard, dtype) -> torch.Tensor:
    """The word embedding rows of ``input_ids`` from a vocab-sharded table
    (this rank's rows [rank * V_loc, (rank + 1) * V_loc)): each rank's own
    rows, zeros for ids outside its shard, summed over the 'model' group."""
    v_loc = (wte_local["q"] if isinstance(wte_local, dict) else wte_local).shape[0]
    ids = input_ids - shard.rank * v_loc
    ok = (ids >= 0) & (ids < v_loc)
    rows = take_embedding(wte_local, ids.clamp(0, v_loc - 1), dtype)
    return shard.reduce_from(torch.where(ok[..., None], rows, torch.zeros_like(rows)))


def embed(params: Params, cfg: GPTConfig, input_ids: torch.Tensor,
          position_ids: Optional[torch.Tensor] = None, shard=None) -> torch.Tensor:
    """Word + learned-position embeddings; word only when ``n_positions``
    is 0 (rotary models, JAX :441). shard (a tensor-parallel
    ``parallel.mesh.Shard``): wte vocab-sharded (:func:`vocab_rows`), wpe
    sharded over d and gathered."""
    if shard is not None and shard.tp:
        hidden = vocab_rows(params["wte"], input_ids, shard, quant_act_dtype(params))
    else:
        hidden = take_embedding(params["wte"], input_ids, quant_act_dtype(params))
    if cfg.n_positions > 0:
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None, :]
        wpe = params["wpe"] if shard is None else shard.gather_from(params["wpe"], -1)
        hidden = hidden + wpe[position_ids].to(hidden.dtype)
    return hidden


# ---------------------------------------------------------------- forward

def column_linear(x: torch.Tensor, p, shard) -> torch.Tensor:
    """``dense.linear``, or with a tensor-parallel shard this rank's
    columns of it (``parallel.mesh.Shard.column``: the input gradient's
    partials summed over the 'model' group in f32)."""
    return shard.column(x, p) if shard is not None and shard.tp else dense.linear(x, p)


def row_linear(x: torch.Tensor, p, shard) -> torch.Tensor:
    """``dense.linear``, or with a tensor-parallel shard the row-parallel
    product of this rank's slice of x and rows of the kernel, its f32
    partials summed over the 'model' group, the bias added once
    (``parallel.mesh.Shard.row``)."""
    return shard.row(x, p) if shard is not None and shard.tp else dense.linear(x, p)


def parallel_mlp(x: torch.Tensor, p, activation: str, shard) -> torch.Tensor:
    """``dense.mlp``, or with a tensor-parallel shard Megatron's MLP: fc1
    column-parallel over this rank's inner columns, fc2 row-parallel."""
    if shard is None or not shard.tp:
        return dense.mlp(x, p, activation)
    h = dense.ACTIVATIONS[activation](shard.column(x, p["fc1"]))
    return shard.row(h, p["fc2"])


def _mlp_and_norms(hidden, residual, lp, mixer_out, cfg, *,
                   train: bool = False, r_d1=None, r_d2=None, shard=None,
                   gidx=None):
    det = not train
    hidden, residual = norms.dropout_add_layer_norm(
        mixer_out, residual, lp["norm1"]["weight"], lp["norm1"]["bias"],
        cfg.resid_pdrop, cfg.layer_norm_epsilon, rng=r_d1, deterministic=det,
        dropout_idx=gidx)
    mlp_out = parallel_mlp(hidden, lp["mlp"], cfg.activation, shard)
    return norms.dropout_add_layer_norm(
        mlp_out, residual, lp["norm2"]["weight"], lp["norm2"]["bias"],
        cfg.resid_pdrop, cfg.layer_norm_epsilon, rng=r_d2, deterministic=det,
        dropout_idx=gidx)


REMAT_MODES = ("none", "full", "dots")


def _dots_policy(ctx, op, *args, **kwargs):
    """The "dots" rematerialization policy (JAX's
    ``dots_with_no_batch_dims_saveable``) for what the port runs: the
    outputs of the 2-D matrix products (``aten.mm``, ``aten.addmm``: the
    block's dense projections Wqkv, out_proj, fc1 and fc2, whose (b, s)
    rows PyTorch folds into one product) are saved; everything else is
    recomputed in the backward: the LayerNorms, GELU, the dropout masks,
    the bias adds and the attention. The flash kernel K3 launches through
    ctypes, which the dispatcher does not see (it sees only the empty
    buffers K3 fills), so K3 launches again in the recomputation, as the
    Pallas call is not a dot for JAX's policy either."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn, mode):
    """A rematerialization mode on a block function (JAX ``remat_wrap``
    :449): "none" (also False / None) saves everything; "full" (True) is
    ``torch.utils.checkpoint`` (non-reentrant): only the block's inputs are
    kept and the whole block runs again in the backward; "dots" keeps the
    matrix products' outputs and recomputes the rest (:func:`_dots_policy`).
    The dropout masks hash positions (``ops/norms.py``, the flash
    kernels), so the recomputation draws the same masks."""
    if mode in (False, None, "none"):
        return fn
    from torch.utils.checkpoint import checkpoint
    if mode in (True, "full"):
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if mode == "dots":
        import functools
        from torch.utils.checkpoint import create_selective_checkpoint_contexts
        ctx = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False, context_fn=ctx)
    raise ValueError(f"unknown remat mode: {mode!r} (one of {REMAT_MODES})")


def _rotary_tables(cfg: GPTConfig, s: int, offset, device):
    """The rotary tables of one forward over s positions from ``offset``
    (an int or per-row (b,)), shared by all its layers; None without
    rotary."""
    if cfg.rotary_emb_dim <= 0:
        return None
    return rotary.rotary_tables(s, cfg.rotary_emb_dim, seqlen_offset=offset,
                                scale_base=cfg.rotary_emb_scale_base,
                                device=device)


def _block(hidden, residual, lp, scale, cfg: GPTConfig, *, train: bool,
           rngs, rot, key_padding_mask=None, shard=None, gidx=None):
    """One pre-norm block with the reordered residual (JAX ``_block`` :372):
    rotary on q and k after the qkv split (``rot``: the forward's
    :func:`_rotary_tables`), attention dropout in the flash kernel (a key
    padding mask takes its ragged entry), then two dropout+add+LN sites,
    keyed by the three splits of the layer's key. shard: a tensor-parallel
    rank's block (Wqkv and fc1 column-parallel over its heads and inner
    columns, out_proj and fc2 row-parallel; ``parallel.mesh.Shard``), gidx
    its per-token dropout positions (``Shard.token_index``)."""
    b, s, _ = hidden.shape
    qkv = column_linear(hidden, lp["Wqkv"], shard)
    qkv = qkv.reshape(b, s, 3, -1, cfg.head_dim)
    h = qkv.shape[3]
    r_attn, r_d1, r_d2 = (prng.split(rngs, 3) if rngs is not None
                          else (None, None, None))
    q, k = qkv[:, :, 0], qkv[:, :, 1]
    if rot is not None:
        q, k = rotary.rotate_qk(q, k, rot)
    at = {} if shard is None else dict(bh_offset=shard.row_offset,
                                       head_offset=shard.rank * h,
                                       global_heads=cfg.n_head)
    ctx = mha(q, k, qkv[:, :, 2], causal=True,
              softmax_scale=scale, key_padding_mask=key_padding_mask,
              dropout_p=cfg.attn_pdrop, dropout_rng=r_attn,
              deterministic=not train, **at)
    mixer_out = row_linear(ctx.reshape(b, s, h * cfg.head_dim), lp["out_proj"], shard)
    return _mlp_and_norms(hidden, residual, lp, mixer_out, cfg, train=train,
                          r_d1=r_d1, r_d2=r_d2, shard=shard, gidx=gidx)


def gpt_forward(params: Params, cfg: GPTConfig, input_ids: torch.Tensor, *,
                position_ids: Optional[torch.Tensor] = None,
                train: bool = False, rng: Optional[torch.Tensor] = None,
                remat="none",
                key_padding_mask: Optional[torch.Tensor] = None,
                shard=None) -> torch.Tensor:
    """Full forward -> post-final-LN hidden states (b, s, d) (JAX
    ``gpt_forward`` :470). Attention goes through the flash wrapper (K3
    forward, K5 backward); the JAX package's ``use_flash=False`` reference
    attention is not a path of the port. train with a key
    ``rng`` (``utils.prng``) turns on the dropout sites: the embedding's,
    and per layer the attention's and the two residual ones.
    position_ids: (b|1, s) rows of the position table (0..s-1 by default).
    key_padding_mask: (b, s) True = a real token, right-padded; as in JAX
    it becomes per-sequence lengths of the ragged flash entry (forward only
    on the card). remat: "none", "full" or "dots", a block at a time
    (:func:`remat_wrap`). shard: this rank's part of a sharded step
    (``parallel.mesh.Shard``): its data shard's rows, from
    ``shard.row_offset``, and with tensor parallelism its heads and columns
    of every layer (the tree of ``training.train``'s sharded init); every
    dropout mask is the unsharded step's, and the hidden states come out
    whole on every rank of the 'model' group."""
    _check_supported(cfg)
    hidden = embed(params, cfg, input_ids, position_ids, shard=shard)
    b, s, d = hidden.shape
    gidx = (shard.token_index(b, s, d, hidden.device)
            if shard is not None and train and rng is not None else None)
    r_emb, r_layers = prng.split(rng) if rng is not None else (None, None)
    hidden, residual = norms.dropout_add_layer_norm(
        hidden, None, params["ln_0"]["weight"], params["ln_0"]["bias"],
        cfg.embd_pdrop, cfg.layer_norm_epsilon, rng=r_emb,
        deterministic=not train, dropout_idx=gidx)
    layer_rngs = (prng.split(r_layers, cfg.n_layer) if r_layers is not None
                  else None)
    rot = _rotary_tables(cfg, s, 0, input_ids.device)
    scales = _softmax_scales(cfg)

    def block(hidden, residual, li):
        # the layer's weights are taken inside the (rematerialized) block,
        # so that a ZeRO-3 tree gathers them again in the recomputation
        return _block(hidden, residual, tree_index(params["layers"], li),
                      scales[li], cfg, train=train,
                      rngs=None if layer_rngs is None else layer_rngs[li],
                      rot=rot, key_padding_mask=key_padding_mask,
                      shard=shard, gidx=gidx)

    block = remat_wrap(block, remat)
    for li in range(cfg.n_layer):
        hidden, residual = block(hidden, residual, li)
    return hidden


# ---------------------------------------------------------------- KV cache

@dataclasses.dataclass
class KVCache:
    """Static-shape KV cache, stacked over layers, in the flat-E layout of
    the decode contraction (E = batch * n_head):

      k:       (n_layer, E, head_dim, max_seqlen) — TRANSPOSED keys
      v:       (n_layer, E, max_seqlen, head_dim)
      k_scale/v_scale: (n_layer, E, max_seqlen) f32 dequant scales (int8)
      length:  number of valid positions: a Python int (uniform batch), or
               a (batch,) int32 tensor on the cache's device (per-slot
               serving rows, ``per_slot=True``)

    int4 caches pack positions pairwise (ops/quant.py): k (n_layer, E,
    head_dim, max_seqlen/2), v (n_layer, E, max_seqlen/2, head_dim), scales
    (n_layer, E, 2, max_seqlen/2).

    The staging block (serving, ``stage=C``): single- and few-token writes
    append at the scalar ``stage_ptr`` instead of writing each row at its
    own position, and :func:`flush_kv_cache` merges the block into the main
    cache every ~C steps. k_stage/v_stage (n_layer, E, C, head_dim) in the
    cache dtype (int8 for int4 caches), ks_stage/vs_stage (n_layer, E, C)
    f32 (quantized caches); stage_pos (batch, C) int32 logical positions
    (-1 free); base_len (batch,) the lengths at the last flush, below which
    the main cache is valid.

    The cache functions update these tensors IN PLACE (JAX returns new
    ones); callers that need the old state copy it first."""
    k: torch.Tensor
    v: torch.Tensor
    length: Union[int, torch.Tensor]
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    k_stage: Optional[torch.Tensor] = None
    v_stage: Optional[torch.Tensor] = None
    ks_stage: Optional[torch.Tensor] = None
    vs_stage: Optional[torch.Tensor] = None
    stage_pos: Optional[torch.Tensor] = None
    stage_ptr: int = 0
    base_len: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8

    @property
    def bits(self) -> int:
        """Stored precision: 16 (fp), 8, or 4, told apart by the scale
        layout as in JAX (int4 scales carry the parity axis)."""
        if not self.quantized:
            return 16
        return 4 if self.k_scale is not None and self.k_scale.dim() == 4 else 8

    @property
    def staged(self) -> bool:
        return self.k_stage is not None


def init_kv_cache(cfg: GPTConfig, batch: int, max_seqlen: int,
                  dtype=torch.bfloat16, device="cuda", *,
                  bits: int = 8, per_slot: bool = False,
                  stage: int = 0) -> KVCache:
    """dtype int8 stores INT8 caches with per-position f32 scales; with
    bits=4 as well, int4 caches pair-packed along positions (max_seqlen
    even), scales in the (E, 2, S/2) parity layout. Decode steps write a
    nibble in place; multi-token writes must start at an even length.
    per_slot=True gives each row its own length (a (batch,) tensor);
    stage > 0 (per_slot only) adds the ``stage``-column staging block (int8
    for int4 caches)."""
    device = _build.resolve_device(device)
    if stage and not per_slot:
        raise ValueError("staging is a serving-slot (per_slot) feature")
    L, e, dh, S = cfg.n_layer, batch * cfg.n_head, cfg.head_dim, max_seqlen
    length = (torch.zeros((batch,), dtype=torch.int32, device=device)
              if per_slot else 0)
    stage_kw = {}
    if stage:
        quantized = dtype == torch.int8
        stage_kw = dict(
            k_stage=torch.zeros((L, e, stage, dh), dtype=dtype, device=device),
            v_stage=torch.zeros((L, e, stage, dh), dtype=dtype, device=device),
            ks_stage=(torch.ones((L, e, stage), dtype=torch.float32,
                                 device=device) if quantized else None),
            vs_stage=(torch.ones((L, e, stage), dtype=torch.float32,
                                 device=device) if quantized else None),
            stage_pos=torch.full((batch, stage), -1, dtype=torch.int32,
                                 device=device),
            base_len=torch.zeros((batch,), dtype=torch.int32, device=device))
    if dtype == torch.int8 and bits == 4:
        if S % 2:
            raise ValueError(f"int4 caches need an even max_seqlen, got {S}")
        ones = lambda: torch.ones((L, e, 2, S // 2), dtype=torch.float32,
                                  device=device)
        return KVCache(
            k=torch.zeros((L, e, dh, S // 2), dtype=dtype, device=device),
            v=torch.zeros((L, e, S // 2, dh), dtype=dtype, device=device),
            length=length, k_scale=ones(), v_scale=ones(), **stage_kw)
    k_scale = v_scale = None
    if dtype == torch.int8:
        k_scale = torch.ones((L, e, S), dtype=torch.float32, device=device)
        v_scale = torch.ones((L, e, S), dtype=torch.float32, device=device)
    return KVCache(k=torch.zeros((L, e, dh, S), dtype=dtype, device=device),
                   v=torch.zeros((L, e, S, dh), dtype=dtype, device=device),
                   length=length, k_scale=k_scale, v_scale=v_scale, **stage_kw)


def stage_targets(stage_pos: torch.Tensor, length: torch.Tensor,
                  rows_per_slot: int, bound: int):
    """The staged entries a flush writes: those with 0 <= pos < length and
    pos < bound. Returns (rows, cols, pos) over the flat-E rows (each slot's
    entry repeated for its rows_per_slot rows): row e, staging column, and
    logical position. Valid entries are unique per (row, position): a write
    invalidates every staged entry at or past its offset. One host sync
    (the selection), once per flush."""
    valid = ((stage_pos >= 0) & (stage_pos < length[:, None])
             & (stage_pos < bound))
    slot, col = valid.nonzero(as_tuple=True)
    h = rows_per_slot
    rows = (slot[:, None] * h
            + torch.arange(h, device=slot.device)[None, :]).reshape(-1)
    return (rows, col.repeat_interleave(h),
            stage_pos[slot, col].long().repeat_interleave(h))


def reset_stage(cache: KVCache) -> None:
    """Empty the staging block after a flush: the main cache now holds
    every position below ``length``."""
    cache.stage_pos.fill_(-1)
    cache.stage_ptr = 0
    cache.base_len.copy_(cache.length)


def flush_kv_cache(cache: KVCache, window: Optional[int] = None) -> KVCache:
    """Merge the staging block into the main cache and reset the stage (JAX
    :227), in place: each valid staged column is written at its logical
    position (JAX streams the window through a one-hot product; the port
    writes the indexed columns). base_len advances to length. window
    bounds the positions written, as the bucketed reads do."""
    if not cache.staged:
        return cache
    if cache.bits == 4:
        return _flush_kv_cache_packed(cache, window)
    b = cache.stage_pos.shape[0]
    S = cache.k.shape[-1]
    w = S if window is None else min(window, S)
    rows, cols, pos = stage_targets(cache.stage_pos, cache.length,
                                    cache.k.shape[1] // b, w)
    # advanced indices around a slice put the index dimension first
    cache.k[:, rows, :, pos] = cache.k_stage[:, rows, cols].transpose(0, 1)
    cache.v[:, rows, pos] = cache.v_stage[:, rows, cols]
    if cache.k_scale is not None:
        cache.k_scale[:, rows, pos] = cache.ks_stage[:, rows, cols]
        cache.v_scale[:, rows, pos] = cache.vs_stage[:, rows, cols]
    reset_stage(cache)
    return cache


def _flush_kv_cache_packed(cache: KVCache,
                           window: Optional[int] = None) -> KVCache:
    """flush_kv_cache for the packed int4 main cache (JAX :283): dequantize
    each staged int8 column, re-quantize it per position to int4 (round
    half to even, as jnp.round) and write its nibbles into packed column
    pos // 2 at parity pos % 2, one parity at a time so that two positions
    of one byte both land."""
    b = cache.stage_pos.shape[0]
    S2 = cache.k.shape[-1]
    w2 = S2 if window is None else min(-(-window // 2), S2)
    rows, cols, pos = stage_targets(cache.stage_pos, cache.length,
                                    cache.k.shape[1] // b, 2 * w2)
    for parity in (0, 1):
        sel = pos % 2 == parity
        r, c, col = rows[sel], cols[sel], pos[sel] // 2
        for buf, sc_buf, st, st_sc, kt_layout in (
                (cache.k, cache.k_scale, cache.k_stage, cache.ks_stage, True),
                (cache.v, cache.v_scale, cache.v_stage, cache.vs_stage, False)):
            vals = st[:, r, c].float() * st_sc[:, r, c][..., None]  # (L, n, d)
            nib, sc = quant.quantize_activations_int4(vals, axis=-1)
            if kt_layout:
                buf[:, r, :, col] = quant.rmw_nibble(
                    buf[:, r, :, col], nib.transpose(0, 1), parity)
            else:
                buf[:, r, col] = quant.rmw_nibble(buf[:, r, col], nib, parity)
            sc_buf[:, :, parity][:, r, col] = sc[..., 0]
    reset_stage(cache)
    return cache


# ---------------------------------------------------------------- int4 writes
#
# The scalar-offset forms of JAX's _store4_step/_store4_scale (:805-832)
# and _store4_prefill/_store4_prefill_scale (:838-862), written in place.
# `buf` is the per-layer view; `axis` its packed-column axis.

def _col(buf: torch.Tensor, axis: int, start: int, stop: int):
    idx = [slice(None)] * buf.dim()
    idx[axis] = slice(start, stop)
    return tuple(idx)


def store4_step(buf: torch.Tensor, nib: torch.Tensor, offset: int,
                axis: int) -> None:
    """One position's nibbles (size 1 on ``axis``) into packed column
    offset // 2: a read-modify-write of that byte column."""
    idx = _col(buf, axis, offset // 2, offset // 2 + 1)
    buf[idx] = quant.rmw_nibble(buf[idx], nib, offset % 2)


def store4_prefill(buf: torch.Tensor, nib: torch.Tensor, offset: int,
                   axis: int) -> None:
    """s positions' nibbles packed pairwise into the columns from
    offset // 2 (offset even). An odd s leaves the last high nibble zero:
    masked by the length, and filled by the next decode step's RMW."""
    s = nib.shape[axis]
    if s % 2:
        pad = [0, 0] * (nib.dim() - axis % nib.dim())
        pad[-1] = 1
        nib = torch.nn.functional.pad(nib, pad)
    packed = quant.pack_int4_pairs(nib, axis)
    c0 = offset // 2
    buf[_col(buf, axis, c0, c0 + packed.shape[axis])] = packed


def store_pair_scale(buf: torch.Tensor, sc: torch.Tensor,
                     offset: int) -> None:
    """Per-position scales sc (E, s) into the (E, 2, S/2) parity layout
    from position ``offset``: one (parity, column) entry when s == 1, else
    the (E, 2, ceil(s/2)) block at column offset // 2 (offset even; an odd
    s pads the last odd scale with 1.0)."""
    s = sc.shape[1]
    if s == 1:
        buf[:, offset % 2, offset // 2] = sc[:, 0]
        return
    if s % 2:
        sc = torch.nn.functional.pad(sc, (0, 1), value=1.0)
    c0 = offset // 2
    buf[:, :, c0:c0 + (s + 1) // 2] = sc.reshape(sc.shape[0], -1, 2
                                                 ).transpose(1, 2)


def check_even_offset(offset: int, s: int) -> None:
    if s > 1 and offset % 2:
        raise ValueError(f"int4 caches take multi-token writes at an even "
                         f"length only, got {s} tokens at length {offset}")


def dequantize_pairs(packed: torch.Tensor, sc2: torch.Tensor, axis: int,
                     dtype) -> torch.Tensor:
    """Pair-packed nibbles and their (E, 2, n) scales -> values in dtype,
    positions interleaved along ``axis`` (1 or 2 of a per-layer view)."""
    scales = quant.interleave_pair_scales(sc2)
    scales = scales[:, None, :] if axis == 2 else scales[..., None]
    return (quant.unpack_int4_pairs(packed, axis).float() * scales).to(dtype)


# ---------------------------------------------------------------- per-row writes
#
# The serving cache writes each row at its own offset. JAX streams the
# window through a masked select (gpt.py:524-697) because XLA:TPU lowers a
# per-row scatter to a serial loop; PyTorch writes the b rows by indexing
# (index_put_), in place. A write at or past the bound (the window, else
# the buffer's length) is dropped, as JAX's masked write drops it: such an
# index is clamped to the last in-bound column and writes back the value
# that column gets anyway, so no host sync is needed to find it.

def _rows_like(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.reshape(t.shape[0], *([1] * (ndim - 1)))


def _masked_row_write(buf: torch.Tensor, new: torch.Tensor,
                      offsets: torch.Tensor, axis: int,
                      bound: Optional[int] = None) -> None:
    """buf (E, ...) <- new (E, ...) along ``axis`` at per-row offsets (E,)
    (JAX :524), in place; positions >= bound are not written."""
    E, s = buf.shape[0], new.shape[axis]
    W = buf.shape[axis] if bound is None else min(bound, buf.shape[axis])
    view = buf.movedim(axis, 1)
    off = offsets.to(torch.long).reshape(E, 1)
    rows = torch.arange(E, device=buf.device)[:, None]
    idx = (off + torch.arange(s, device=buf.device)[None, :]).clamp(max=W - 1)
    vals = new.movedim(axis, 1).to(buf.dtype)[rows, (idx - off).clamp(min=0)]
    view[rows, idx] = torch.where(_rows_like(off < W, vals.dim()), vals,
                                  view[rows, idx])


def update_rows_axis(buf: torch.Tensor, new: torch.Tensor, offsets,
                     axis: int) -> None:
    """buf (E, ...) <- new (E, ...) along ``axis`` (absolute, counting the
    row axis) at a scalar offset or per-row (E,) offsets (JAX :570)."""
    if isinstance(offsets, torch.Tensor):
        _masked_row_write(buf, new, offsets, axis)
        return
    buf[_col(buf, axis, offsets, offsets + new.shape[axis])] = new.to(buf.dtype)


def update_rows_axis_windowed(buf: torch.Tensor, new: torch.Tensor, offsets,
                              axis: int, window: Optional[int]) -> None:
    """update_rows_axis with per-row writes bounded by ``window`` (JAX
    :582; callers guarantee max(offsets) + s <= window for the rows that
    matter)."""
    if isinstance(offsets, torch.Tensor):
        _masked_row_write(buf, new, offsets, axis, window)
    else:
        update_rows_axis(buf, new, offsets, axis)


def _packed_bound(buf: torch.Tensor, axis: int, window: Optional[int]) -> int:
    S2 = buf.shape[axis]
    return S2 if window is None else min(-(-window // 2), S2)


def rmw_nibble_axis_windowed(buf: torch.Tensor, nib: torch.Tensor, offsets,
                             axis: int, window: Optional[int] = None) -> None:
    """ONE position's nibbles (size 1 on ``axis``) into a pair-packed cache
    at scalar or per-row (E,) position offsets (JAX :601): packed column
    offset // 2, parity offset % 2, a read-modify-write of that byte per
    row. Per-row writes at columns >= ceil(window / 2) are dropped."""
    if not isinstance(offsets, torch.Tensor):
        store4_step(buf, nib, offsets, axis)
        return
    E = buf.shape[0]
    w2 = _packed_bound(buf, axis, window)
    view = buf.movedim(axis, 1)                            # (E, S2, ...)
    off = offsets.to(torch.long)
    rows = torch.arange(E, device=buf.device)
    idx = (off // 2).clamp(max=w2 - 1)
    old = view[rows, idx]                                  # (E, ...)
    new = quant.rmw_nibble(old, nib.movedim(axis, 1)[:, 0],
                           _rows_like(off % 2, old.dim()))
    view[rows, idx] = torch.where(_rows_like(off // 2 < w2, old.dim()), new,
                                  old)


def store_split8_step(buf: torch.Tensor, val: torch.Tensor, offsets,
                      window: Optional[int] = None) -> None:
    """ONE position into an even/odd split int8 key cache (JAX :640): buf
    (E, dk, 2, S/2) <- val (E, dk, 1) at (parity, packed column) =
    (offset % 2, offset // 2), scalar or per-row offsets."""
    if not isinstance(offsets, torch.Tensor):
        buf[:, :, offsets % 2, offsets // 2] = val[..., 0].to(buf.dtype)
        return
    w2 = _packed_bound(buf, 3, window)
    off = offsets.to(torch.long)
    rows = torch.arange(buf.shape[0], device=buf.device)
    par, idx = off % 2, (off // 2).clamp(max=w2 - 1)
    old = buf[rows, :, par, idx]                           # (E, dk)
    buf[rows, :, par, idx] = torch.where((off // 2 < w2)[:, None],
                                         val[..., 0].to(buf.dtype), old)


def update_pair_scale(scale_buf: torch.Tensor, val: torch.Tensor, offsets,
                      window: Optional[int] = None) -> None:
    """scale_buf (E, 2, S/2) <- val (E,) at (parity, packed column) =
    (offset % 2, offset // 2), scalar or per-row offsets (JAX :666)."""
    if not isinstance(offsets, torch.Tensor):
        scale_buf[:, offsets % 2, offsets // 2] = val
        return
    w2 = _packed_bound(scale_buf, 2, window)
    off = offsets.to(torch.long)
    rows = torch.arange(scale_buf.shape[0], device=scale_buf.device)
    par, idx = off % 2, (off // 2).clamp(max=w2 - 1)
    scale_buf[rows, par, idx] = torch.where(off // 2 < w2, val.float(),
                                            scale_buf[rows, par, idx])


# ---------------------------------------------------------------- cached forward

def per_row(x, h: int):
    """A (b,) per-slot tensor repeated over each slot's h flat-E rows."""
    return x.repeat_interleave(h, dim=0)


def _stage_write(cache: KVCache, offset: torch.Tensor, s: int,
                 staged: bool) -> None:
    """The stage bookkeeping of a write at per-row ``offset`` (JAX
    :783-795): every staged entry at or past the offset is stale
    (speculative rollback, slot re-prefill) and is dropped; a staged write
    records its columns' positions at the stage pointer."""
    pos = cache.stage_pos
    pos.masked_fill_(pos >= offset[:, None], -1)
    if staged:
        ptr = cache.stage_ptr
        if ptr + s > pos.shape[1]:
            raise ValueError(f"staging block full: {ptr} + {s} columns > "
                             f"{pos.shape[1]}; flush first")
        pos[:, ptr:ptr + s] = (offset[:, None]
                               + torch.arange(s, device=pos.device)[None, :])


def gpt_forward_with_cache(
    params: Params, cfg: GPTConfig, input_ids: torch.Tensor, cache: KVCache, *,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Forward over ``input_ids`` starting at position ``cache.length``,
    writing the new keys/values into ``cache`` IN PLACE and advancing its
    length. Returns (hidden, cache).

    Three attention branches: s == 1 -> decode kernel (K1, or K8 over int4
    caches) over the stored-precision cache; s <= FLAT_MULTI_MAX -> the
    flat multi-query contraction (int4 caches take the prefill branch, as
    in JAX); otherwise prefill -> flash (K3) over the (dequantized) cache
    prefix with ``seq_lengths = new length`` and a causal offset.

    Per-slot caches (tensor lengths) write each row at its own offset. On
    a staged cache, writes of s <= min(FLAT_MULTI_MAX, C) tokens append to
    the staging block and attend over two segments: the main cache below
    base_len through K1's (m, l) form (K8-ml over int4 caches), the staged
    columns in plain PyTorch, merged; a larger write goes to the main cache
    and advances base_len.

    window: static upper bound on the valid length after this call
    (caller-guaranteed length + s <= window); attention reads only the
    first ``window`` cache columns (int4: ceil(window / 2) packed
    columns)."""
    _check_supported(cfg)
    b, s = input_ids.shape
    offset = cache.length
    vec = isinstance(offset, torch.Tensor)
    new_len = offset + s
    q4 = cache.bits == 4
    S_all = cache.k.shape[-1] * (2 if q4 else 1)
    if not vec and (new_len > S_all or (window is not None and new_len > window)):
        raise ValueError(f"cache overflow: length {offset} + {s} exceeds "
                         f"max {S_all} / window {window}")
    staged = cache.staged and vec and s <= min(FLAT_MULTI_MAX,
                                               cache.stage_pos.shape[1])
    if q4 and s > 1 and (vec or cache.staged):
        raise ValueError("int4 caches take multi-token writes at a uniform "
                         "(scalar) offset only, and staged int4 caches "
                         "single-token steps only")
    if q4 and not vec:
        check_even_offset(offset, s)
    W = S_all if window is None else min(window, S_all)
    W2 = -(-W // 2)                     # int4: packed columns of the window
    dev = input_ids.device
    h, dk = cfg.n_head, cfg.head_dim
    e = b * h
    if vec:
        # rows past the model's positions (idle serving slots keep
        # advancing) gather the last one, as JAX's clamped gather does
        position_ids = (offset[:, None].long()
                        + torch.arange(s, device=dev)[None, :]
                        ).clamp(max=max(cfg.n_positions - 1, 0))
        offs_e, lens_e = per_row(offset, h), per_row(new_len, h)
    else:
        position_ids = offset + torch.arange(s, device=dev)[None, :]
        offs_e, lens_e = offset, new_len
    if cache.staged:
        ptr0 = cache.stage_ptr
        _stage_write(cache, offset, s, staged)
        if staged:
            cache.stage_ptr = ptr0 + s
            base_e = per_row(cache.base_len, h)
            pos_e = per_row(cache.stage_pos, h)
    hidden = embed(params, cfg, input_ids, position_ids)
    hidden, residual = norms.dropout_add_layer_norm(
        hidden, None, params["ln_0"]["weight"], params["ln_0"]["bias"],
        0.0, cfg.layer_norm_epsilon)
    rot = _rotary_tables(cfg, s, offset, dev)
    for li, scale in enumerate(_softmax_scales(cfg)):
        lp = tree_index(params["layers"], li)
        qkv = dense.linear(hidden, lp["Wqkv"]).reshape(b, s, 3, h, dk)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if rot is not None:
            # before the cache write, so cached keys are rotated (JAX :871)
            q, k = rotary.rotate_qk(q, k, rot)
        v_new = v.transpose(1, 2).reshape(e, s, dk)
        if staged:
            # append at the stage pointer; the main cache is untouched
            # until flush_kv_cache
            k_st_new = k.transpose(1, 2).reshape(e, s, dk)
            cols = slice(ptr0, ptr0 + s)
            if cache.quantized:
                k8, kss = quant.quantize_activations_int8(k_st_new, axis=2)
                v8, vss = quant.quantize_activations_int8(v_new, axis=2)
                cache.k_stage[li, :, cols] = k8
                cache.v_stage[li, :, cols] = v8
                cache.ks_stage[li, :, cols] = kss[..., 0]
                cache.vs_stage[li, :, cols] = vss[..., 0]
            else:
                cache.k_stage[li, :, cols] = k_st_new.to(cache.k_stage.dtype)
                cache.v_stage[li, :, cols] = v_new.to(cache.v_stage.dtype)
        else:
            kt_new = k.permute(0, 2, 3, 1).reshape(e, dk, s)
            if q4:
                k4q, ks = quant.quantize_activations_int4(kt_new, axis=1)
                v4q, vs = quant.quantize_activations_int4(v_new, axis=2)
                if vec:
                    rmw_nibble_axis_windowed(cache.k[li], k4q, offs_e, 2, W)
                    rmw_nibble_axis_windowed(cache.v[li], v4q, offs_e, 1, W)
                    update_pair_scale(cache.k_scale[li], ks[:, 0, 0], offs_e, W)
                    update_pair_scale(cache.v_scale[li], vs[:, 0, 0], offs_e, W)
                else:
                    store = store4_step if s == 1 else store4_prefill
                    store(cache.k[li], k4q, offset, axis=2)
                    store(cache.v[li], v4q, offset, axis=1)
                    store_pair_scale(cache.k_scale[li], ks[:, 0, :], offset)
                    store_pair_scale(cache.v_scale[li], vs[..., 0], offset)
            elif cache.quantized:
                k8, ks = quant.quantize_activations_int8(kt_new, axis=1)
                v8, vs = quant.quantize_activations_int8(v_new, axis=2)
                update_rows_axis_windowed(cache.k[li], k8, offs_e, 2, W)
                update_rows_axis_windowed(cache.v[li], v8, offs_e, 1, W)
                update_rows_axis_windowed(cache.k_scale[li], ks[:, 0, :],
                                          offs_e, 1, W)
                update_rows_axis_windowed(cache.v_scale[li], vs[..., 0],
                                          offs_e, 1, W)
            else:
                update_rows_axis_windowed(cache.k[li], kt_new, offs_e, 2, W)
                update_rows_axis_windowed(cache.v[li], v_new, offs_e, 1, W)
        if q4:
            kt_c, v_c = cache.k[li, :, :, :W2], cache.v[li, :, :W2]
            k_sc, v_sc = cache.k_scale[li, ..., :W2], cache.v_scale[li, ..., :W2]
        else:
            kt_c, v_c = cache.k[li, :, :, :W], cache.v[li, :, :W]
            k_sc = cache.k_scale[li, :, :W] if cache.quantized else None
            v_sc = cache.v_scale[li, :, :W] if cache.quantized else None
        # the decode steps' query dtype: a floating cache's own (an f32
        # cache under bf16 weights, as JAX's PPLM keeps one, runs its steps
        # in f32 as JAX's promotion does; the kernels take q and a floating
        # cache in one dtype), else the activations'
        qd = kt_c.dtype if kt_c.is_floating_point() else q.dtype
        if staged:
            qf = (q.float() * scale).to(q.dtype)
            stage = (cache.k_stage[li], cache.ks_stage[li] if cache.quantized
                     else None, cache.v_stage[li],
                     cache.vs_stage[li] if cache.quantized else None, pos_e,
                     lens_e)
            if q4:
                # K8-ml over the read-only packed cache, valid to base_len,
                # merged with the int8 stage segment
                q_flat = qf[:, 0].reshape(e, dk)
                main = decode_attention_int4_ml(q_flat, kt_c, k_sc, v_c, v_sc,
                                                base_e)
                ctx = merge_softmax_segments(
                    *main, *stage_segment_attention(q_flat, *stage))
                ctx = ctx.reshape(b, 1, h, dk)
            elif s == 1:
                ctx = decode_attention_staged(qf[:, 0].reshape(e, dk), kt_c,
                                              k_sc, v_c, v_sc, base_e, *stage)
                ctx = ctx.reshape(b, 1, h, dk)
            else:
                q_flat = qf.transpose(1, 2).reshape(e, s, dk)
                ctx = decode_attention_flat_multi_staged(
                    q_flat, kt_c, k_sc, v_c, v_sc, base_e, *stage)
                ctx = ctx.reshape(b, h, s, dk).transpose(1, 2)
        elif s == 1:
            q_flat = (q[:, 0].float() * scale).to(qd).reshape(e, dk)
            decode = decode_attention_int4 if q4 else decode_attention
            ctx = decode(q_flat, kt_c, k_sc, v_c, v_sc, lens_e)
            ctx = ctx.to(q.dtype).reshape(b, 1, h, dk)
        elif s <= FLAT_MULTI_MAX and not q4:
            qf = (q.float() * scale).to(qd)
            q_flat = qf.transpose(1, 2).reshape(e, s, dk)
            ctx = decode_attention_flat_multi(q_flat, kt_c, k_sc, v_c, v_sc,
                                              lens_e)
            ctx = ctx.to(q.dtype).reshape(b, h, s, dk).transpose(1, 2)
        else:
            # prefill: attend over the cache prefix (keys already quantized
            # for INT8 caches); one relayout per prefill, never per step
            if q4:
                kd = dequantize_pairs(kt_c, k_sc, 2, q.dtype)
                vd = dequantize_pairs(v_c, v_sc, 1, q.dtype)
            elif cache.quantized:
                kd = (kt_c.float() * k_sc[:, None, :]).to(q.dtype)
                vd = (v_c.float() * v_sc[..., None]).to(q.dtype)
            else:
                kd, vd = kt_c.to(q.dtype), v_c.to(q.dtype)
            Wd = vd.shape[1]
            kd = kd.reshape(b, h, dk, Wd).permute(0, 3, 1, 2).contiguous()
            vd = vd.reshape(b, h, Wd, dk).transpose(1, 2)
            lens = (new_len.to(torch.int32) if vec else
                    torch.full((b,), new_len, dtype=torch.int32, device=dev))
            ctx = mha(q, kd, vd, causal=True, softmax_scale=scale,
                      seq_lengths=lens, q_offset=offset)
        mixer_out = dense.linear(ctx.reshape(b, s, cfg.n_embd), lp["out_proj"])
        hidden, residual = _mlp_and_norms(hidden, residual, lp, mixer_out,
                                          cfg)
    cache.length = new_len
    if cache.staged and not staged:
        # a large write on a staged cache went to the main cache: every
        # row's flushed horizon advances with it (JAX :1086)
        cache.base_len.copy_(new_len)
    return hidden, cache


# ---------------------------------------------------------------- LM head

def lm_logits(params: Params, cfg: GPTConfig, hidden: torch.Tensor,
              shard=None) -> torch.Tensor:
    """Tied lm_head: hidden @ wte^T, in hidden's dtype. Quantized trees
    carry an explicit quantized (d, V) 'lm_head' and return f32 logits.
    With a tensor-parallel shard: this rank's vocabulary columns, from its
    vocab shard of wte (a column-parallel product)."""
    if "lm_head" in params:
        return quant.quant_linear(hidden, params["lm_head"]).float()
    wte = params["wte"]
    if shard is not None and shard.tp:
        return shard.column(hidden, {"kernel": wte.t()})
    if hidden.dtype == torch.bfloat16 and wte.dtype == torch.bfloat16:
        return hidden @ wte.T
    return (hidden.float() @ wte.float().T).to(hidden.dtype)


def gpt_lm_forward(params: Params, cfg: GPTConfig, input_ids: torch.Tensor,
                   **kw) -> torch.Tensor:
    """GPT LM with the tied head: logits (b, s, V) (JAX :1127); with a
    tensor-parallel ``shard=`` this rank's vocabulary columns."""
    return lm_logits(params, cfg, gpt_forward(params, cfg, input_ids, **kw),
                     shard=kw.get("shard"))
