"""Backpack language model (PyTorch port): training forward and inference.

Port of ``backpacks_flash_attn_tpu/models/backpack.py``:

    o_t = sum_{k=1..nv} sum_{j<=t} alpha[k, t, j] * C(x_j)[k],
    logits_t = E @ o_t  (E = tied word embedding)

The contextualization network is the GPT stack of ``models/gpt.py``; the
sense network is per-token (word embeddings, no positions, one MLP-only
block, a d -> nv*d MLP), so a quantized tree may replace it by a gathered
(vocab, nv, d) table. Decode is incremental: GPT KV cache + cached
contextualization keys + cached senses, computing one alpha row per step.
Training splits the dropout keys as the JAX package does (``utils.prng``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..config import BackpackConfig
from ..ops import _build, dense, norms, quant
from ..ops.attention import MASK_VALUE
from ..ops.backpack_kernels import fused_contextualization
from ..ops.decode_attention import (decode_attention,
                                    decode_attention_flat_multi,
                                    decode_attention_flat_multi_staged,
                                    decode_attention_mixed,
                                    decode_attention_staged)
from ..utils import prng
from . import gpt as gpt_lib

Params = Dict[str, Any]


# ---------------------------------------------------------------- init

def init_backpack(cfg: BackpackConfig, generator: torch.Generator,
                  dtype=torch.float32, device="cuda") -> Params:
    """Random Backpack weights drawn from ``generator`` (the JAX tree's
    layout and init scales; the numbers differ from JAX's)."""
    device = _build.resolve_device(device)
    d = cfg.n_embd
    std = cfg.initializer_range
    out_std = std / (2 * cfg.n_layer) ** 0.5
    inner = d if cfg.shrink_final_inner else cfg.inner_dim
    kw = dict(dtype=dtype, device=device)
    blocks = [{
        "norm1": norms.init_layer_norm(d, **kw),
        "mlp": dense.init_mlp(generator, d, cfg.inner_dim, std=std,
                              out_std=out_std, **kw),
        "norm2": norms.init_layer_norm(d, **kw),
    } for _ in range(cfg.content_n_layer)]
    return {
        "gpt": gpt_lib.init_gpt(cfg, generator, dtype, device),
        "ctx_attn": {"Wqkv": dense.init_linear(generator, d, 2 * d, std=std,
                                               **kw)},
        "content": {
            "ln_0": norms.init_layer_norm(d, **kw),
            "blocks": gpt_lib._stack(blocks),
            "final_mlp": dense.init_mlp(generator, d, inner,
                                        cfg.num_senses * d, std=std,
                                        out_std=out_std, **kw),
        },
    }


# ---------------------------------------------------------------- pieces

def context_qk(params: Params, cfg: BackpackConfig,
               hidden: torch.Tensor, shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contextualization hidden states -> nv-headed q, k, each
    (b, s, nv, d/nv); with a tensor-parallel shard this rank's nv / tp
    heads (its column-parallel Wqkv)."""
    b, s, d = hidden.shape
    qk = gpt_lib.column_linear(hidden, params["ctx_attn"]["Wqkv"], shard)
    # nv heads, or a tensor-parallel rank's nv / tp (its Wqkv columns)
    qk = qk.reshape(b, s, 2, -1, cfg.sense_head_dim)
    return qk[:, :, 0], qk[:, :, 1]


def contextualization(params: Params, cfg: BackpackConfig,
                      hidden: torch.Tensor, shard=None) -> torch.Tensor:
    """alpha = causal softmax over nv-headed scores, materialized
    (b, nv, s, s) in hidden's dtype (the return_parts path); a
    tensor-parallel shard's nv / tp heads."""
    q, k = context_qk(params, cfg, hidden, shard)
    scale = cfg.sense_head_dim ** -0.5
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float() * scale)
    s = scores.shape[-1]
    pos = torch.arange(s, device=hidden.device)
    scores = scores + torch.where(pos[None, :] <= pos[:, None], 0.0,
                                  MASK_VALUE)[None, None]
    return torch.softmax(scores, dim=-1).to(hidden.dtype)


def content_forward(params: Params, cfg: BackpackConfig,
                    input_ids: torch.Tensor, *, train: bool = False,
                    rng: Optional[torch.Tensor] = None,
                    embedded: Optional[torch.Tensor] = None,
                    dropout_idx: Optional[torch.Tensor] = None,
                    shard=None) -> torch.Tensor:
    """Sense network C(x): (b, s) -> (b, s, nv, d); strictly per-token. A
    quantized tree with a precomputed sense table gathers from it (and
    ignores ``embedded``). embedded: the pre-gathered wte rows (b, s, d),
    in place of the embedding gather (JAX :107; the tensor-parallel decode
    step, ``parallel/tp_decode.py``, sums its vocab-sharded rows once). In
    training, the embedding's dropout site takes the first split of
    ``rng`` and each block's two sites a (n_blocks, 2) split of the second
    (JAX :141-170). dropout_idx: the global flat positions of this chunk's
    elements in the unsharded (B, S, d) tensor, for every site (a
    sequence-sharded caller, ``parallel/cp_train.py``; a data-sharded one).
    shard: a tensor-parallel rank (``parallel.mesh.Shard``): the
    vocab-sharded embedding, the blocks' MLPs Megatron's, and final_mlp's
    fc1 and fc2 both column-parallel (fc1's output gathered before fc2), so
    the senses come out sense-sharded: (b, s, nv / tp, d), this rank's
    senses [rank * nv / tp, (rank + 1) * nv / tp)."""
    b, s = input_ids.shape
    cp = params["content"]
    act = gpt_lib.quant_act_dtype(params["gpt"])
    if "table" in cp:
        t = cp["table"]
        rows = t.q[input_ids]
        if t.bits == 4:
            rows = quant.unpack_int4_last(rows)
        scales = t.scale[input_ids]
        d = rows.shape[-1]
        if scales.shape[-1] not in (1, d):
            scales = scales.repeat_interleave(d // scales.shape[-1], dim=-1)
        return (rows.float() * scales).to(act)
    tp = shard is not None and shard.tp
    if embedded is not None:
        hidden = embedded
    elif tp:
        hidden = gpt_lib.vocab_rows(params["gpt"]["wte"], input_ids, shard, act)
    else:
        hidden = gpt_lib.take_embedding(params["gpt"]["wte"], input_ids, act)
    n_blocks = cp["blocks"]["norm1"]["weight"].shape[0]
    r_emb, blk_rngs = None, None
    if rng is not None:
        r_emb, r_rest = prng.split(rng)
        blk_rngs = prng.split(r_rest, (n_blocks, 2))
    det, eps, pdrop = not train, cfg.layer_norm_epsilon, cfg.resid_pdrop
    hidden, residual = norms.dropout_add_layer_norm(
        hidden, None, cp["ln_0"]["weight"], cp["ln_0"]["bias"],
        cfg.embd_pdrop, eps, rng=r_emb, deterministic=det,
        dropout_idx=dropout_idx)
    for i in range(n_blocks):
        blk = gpt_lib.tree_index(cp["blocks"], i)
        r1, r2 = (None, None) if blk_rngs is None else blk_rngs[i]
        # no-mix block: the identity mixer still feeds `hidden` into the
        # residual stream
        hidden, residual = norms.dropout_add_layer_norm(
            hidden, residual, blk["norm1"]["weight"], blk["norm1"]["bias"],
            pdrop, eps, rng=r1, deterministic=det, dropout_idx=dropout_idx)
        mlp_out = gpt_lib.parallel_mlp(hidden, blk["mlp"], cfg.activation, shard)
        hidden, residual = norms.dropout_add_layer_norm(
            mlp_out, residual, blk["norm2"]["weight"], blk["norm2"]["bias"],
            pdrop, eps, rng=r2, deterministic=det, dropout_idx=dropout_idx)
    fm = cp["final_mlp"]
    if tp:
        h = dense.ACTIVATIONS[cfg.activation](shard.column(hidden, fm["fc1"]))
        senses = shard.column(shard.gather_from(h, -1), fm["fc2"])
    else:
        senses = dense.mlp(hidden, fm, cfg.activation)
    return senses.reshape(b, s, -1, cfg.n_embd)


def sense_table(params: Params, cfg: BackpackConfig,
                chunk: int = 4096) -> torch.Tensor:
    """Materialize the (vocab, nv, d) sense table (valid because the sense
    network is position- and context-independent)."""
    v = cfg.padded_vocab_size
    dev = params["content"]["ln_0"]["weight"].device
    ids = torch.arange(v, device=dev)
    return torch.cat([content_forward(params, cfg, c[None, :])[0]
                      for c in ids.split(chunk)])


# ---------------------------------------------------------------- forward

def apply_sense_edit(content: torch.Tensor, input_ids: torch.Tensor,
                     sense_edit: Tuple[torch.Tensor, torch.Tensor]
                     ) -> torch.Tensor:
    """Replace the sense vectors of edited tokens (JAX :200): content (b, s,
    nv, d), sense_edit = (edited_ids (m,), edited_senses (m, nv, d)); a
    token listed twice takes its first entry."""
    edited_ids, edited_senses = sense_edit
    match = input_ids[..., None] == edited_ids.to(input_ids.device)[None, None]
    idx = match.int().argmax(dim=-1)                # the first match
    repl = edited_senses.to(content.device)[idx]    # (b, s, nv, d)
    return torch.where(match.any(-1)[..., None, None], repl.to(content.dtype),
                       content)


def backpack_forward(params: Params, cfg: BackpackConfig,
                     input_ids: torch.Tensor, *, train: bool = False,
                     rng: Optional[torch.Tensor] = None,
                     sense_weights: Optional[torch.Tensor] = None,
                     sense_edit: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                     return_parts: bool = False, remat="none",
                     fused_ctx: Optional[bool] = None, shard=None):
    """Forward -> logits (b, s, vocab) (JAX ``backpack_forward`` :213).
    The GPT attention goes to the flash wrapper (K3, K5 backward). The
    combine takes the fused kernel (K4, K6 backward; alpha is never
    stored) when ``fused_ctx``, else the einsum over a materialized alpha;
    by default fused_ctx = not train, JAX's rule (:271) with the flash
    attention the port always takes.
    train with a key ``rng`` turns dropout on; its first split keys the GPT
    stack and its second the sense network. return_parts takes the einsum
    path and also returns {'alpha', 'content', 'contextual', 'outputs'}.
    sense_weights: (nv,) or (b, s, nv) multiplicative weights on the sense
    vectors, sense_edit: (edited_ids (m,), edited_senses (m, nv, d))
    replacing the senses of those tokens; both act on ``content`` before
    the combine, so either route takes them (the intervention hooks,
    models/interventions.py).
    remat ("none", "full", "dots"; ``gpt.remat_wrap``) rematerializes the
    GPT blocks and, on the einsum route, the whole combine under any mode
    but "none" (JAX :293): alpha (b, nv, s, s) is recomputed in the
    backward instead of saved. shard (``parallel.mesh.Shard``): this rank's
    part of a sharded step; with tensor parallelism the combine runs on its
    nv / tp senses (K4 and K6 on them on the fused route), their partial
    sum is summed over the 'model' group, and the logits are this rank's
    vocabulary columns (``ops.cross_entropy.vocab_parallel_cross_entropy``
    takes them)."""
    tp = shard is not None and shard.tp
    if tp and (sense_weights is not None or sense_edit is not None or return_parts):
        raise ValueError("sense_weights, sense_edit and return_parts take the "
                         "unsharded forward")
    r_gpt, r_content = prng.split(rng) if rng is not None else (None, None)
    contextl = gpt_lib.gpt_forward(params["gpt"], cfg, input_ids,
                                   train=train, rng=r_gpt, remat=remat,
                                   shard=shard)
    gidx = None
    if shard is not None and train and rng is not None:
        gidx = shard.token_index(*contextl.shape, contextl.device)
    content = content_forward(params, cfg, input_ids, train=train,
                              rng=r_content, dropout_idx=gidx,
                              shard=shard)                      # (b, s, nv, d)
    if sense_edit is not None:
        content = apply_sense_edit(content, input_ids, sense_edit)
    if sense_weights is not None:
        w = (sense_weights[None, None, :] if sense_weights.dim() == 1
             else sense_weights)
        content = content * w[..., None].to(content.dtype)
    if fused_ctx is None:
        fused_ctx = not train
    scale = cfg.sense_head_dim ** -0.5
    alpha = None
    # a tensor-parallel rank sums its senses' part of the combine over the
    # 'model' group; the einsum's part stays f32 until the sum
    part_dtype = torch.float32 if tp else contextl.dtype

    def combine(hidden, content):
        a = contextualization(params, cfg, hidden, shard)
        return torch.einsum("bkts,bskd->btd", a.to(part_dtype),
                            content.to(part_dtype)).to(part_dtype), a

    if fused_ctx and not return_parts:
        q, ctx_k = context_qk(params, cfg, contextl, shard)
        outputs = fused_contextualization(q, ctx_k, content,
                                          scale).to(contextl.dtype)
    elif return_parts or remat in (False, None, "none"):
        outputs, alpha = combine(contextl, content)
    else:
        from torch.utils.checkpoint import checkpoint
        outputs = checkpoint(lambda h, c: combine(h, c)[0], contextl, content,
                             use_reentrant=False)
    if tp:
        outputs = shard.reduce_from(outputs)
    outputs = outputs.to(contextl.dtype)
    logits = gpt_lib.lm_logits(params["gpt"], cfg, outputs, shard=shard)
    if return_parts:
        return logits, {"alpha": alpha, "content": content,
                        "contextual": contextl, "outputs": outputs}
    return logits


# ---------------------------------------------------------------- decode

@dataclasses.dataclass
class BackpackCache:
    """Incremental-decode state in the flat-E layouts (E = batch * nv):

      gpt:           the GPT KVCache
      ctx_k:         (E, dnv_pad, S) transposed contextualization keys, head
                     dim zero-padded to 64; int8 with ctx_k_scale when
                     quantized
      content:       (E, S, d) per-token sense vectors
      content_scale: (E, S) f32 int8 dequant scales (int8 cache only)
      length:        a Python int, or (batch,) int32 per-slot lengths

    The mixed low-bit cache (bits 4) keeps ctx_k int8 in the even/odd split
    layout (E, dnv_pad, 2, S/2) and the senses int4 pair-packed
    (E, S/2, d), both scales (E, 2, S/2).

    The staging block (serving; its pointer, positions and base_len live on
    the nested gpt cache): ctx_k_stage (E, C, dnv_pad), content_stage
    (E, C, d) in the cache dtype, ctx_ks_stage/content_ss_stage (E, C) f32
    (int8 caches).

    Updated IN PLACE by backpack_forward_with_cache (JAX returns new
    caches); copy the tensors before a call whose old state you need."""
    gpt: gpt_lib.KVCache
    ctx_k: torch.Tensor
    content: torch.Tensor
    length: Union[int, torch.Tensor]
    content_scale: Optional[torch.Tensor] = None
    ctx_k_scale: Optional[torch.Tensor] = None
    ctx_k_stage: Optional[torch.Tensor] = None
    ctx_ks_stage: Optional[torch.Tensor] = None
    content_stage: Optional[torch.Tensor] = None
    content_ss_stage: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.content.dtype == torch.int8

    @property
    def bits(self) -> int:
        """Stored precision of the ctx-K and sense caches: 16, 8, or 4,
        told apart by the scale layout as in JAX."""
        if not self.quantized:
            return 16
        return 4 if self.content_scale.dim() == 3 else 8

    @property
    def staged(self) -> bool:
        return self.ctx_k_stage is not None


def init_backpack_cache(cfg: BackpackConfig, batch: int, max_seqlen: int,
                        dtype=torch.bfloat16, device="cuda", *,
                        bits: int = 8, kv_bits: Optional[int] = None,
                        per_slot: bool = False,
                        stage: int = 0) -> BackpackCache:
    """dtype int8: INT8 GPT-KV, ctx-K and sense caches with per-position
    f32 scales. bits=4 (with dtype int8) makes the ctx-K and sense caches
    the mixed low-bit cache (see BackpackCache); kv_bits sets the GPT KV
    cache's precision apart (default: bits), as in JAX (:500). per_slot
    gives each row its own length; stage > 0 adds the staging blocks (not
    with the mixed cache, as in JAX; with kv_bits=4 the GPT stage is
    int8)."""
    device = _build.resolve_device(device)
    kv_bits = bits if kv_bits is None else kv_bits
    e, S = batch * cfg.num_senses, max_seqlen
    gpt = gpt_lib.init_kv_cache(cfg, batch, max_seqlen, dtype, device,
                                bits=kv_bits, per_slot=per_slot, stage=stage)
    length = (torch.zeros((batch,), dtype=torch.int32, device=device)
              if per_slot else 0)
    if dtype == torch.int8 and bits == 4:
        if S % 2:
            raise ValueError(f"int4 caches need an even max_seqlen, got {S}")
        if stage:
            raise ValueError("the mixed low-bit cache takes no staging block")
        ones = lambda: torch.ones((e, 2, S // 2), dtype=torch.float32,
                                  device=device)
        return BackpackCache(
            gpt=gpt,
            ctx_k=torch.zeros((e, cfg.sense_head_dim_padded, 2, S // 2),
                              dtype=dtype, device=device),
            content=torch.zeros((e, S // 2, cfg.n_embd), dtype=dtype,
                                device=device),
            length=length, content_scale=ones(), ctx_k_scale=ones())
    scales = dtype == torch.int8
    ones = lambda n: torch.ones((e, n), dtype=torch.float32, device=device)
    stage_kw = {}
    if stage:
        stage_kw = dict(
            ctx_k_stage=torch.zeros((e, stage, cfg.sense_head_dim_padded),
                                    dtype=dtype, device=device),
            content_stage=torch.zeros((e, stage, cfg.n_embd), dtype=dtype,
                                      device=device),
            ctx_ks_stage=ones(stage) if scales else None,
            content_ss_stage=ones(stage) if scales else None)
    return BackpackCache(
        gpt=gpt,
        ctx_k=torch.zeros((e, cfg.sense_head_dim_padded, S), dtype=dtype,
                          device=device),
        content=torch.zeros((e, S, cfg.n_embd), dtype=dtype, device=device),
        length=length,
        content_scale=ones(S) if scales else None,
        ctx_k_scale=ones(S) if scales else None,
        **stage_kw)


def insert_cache_slot(big: BackpackCache, small: BackpackCache,
                      slot: int) -> BackpackCache:
    """Copy a batch-1 cache (a freshly prefilled request) into row ``slot``
    of a per-slot batch cache, in place (JAX :315), and return it. The
    flat-E layouts put slot b's rows at [b * rows_per_slot, (b+1) *
    rows_per_slot). A staged cache drops the slot's staged entries and sets
    its flushed horizon to the prefill length (the prefill went to the
    main rows)."""
    g_big, g_small = big.gpt, small.gpt
    h = g_small.k.shape[1]          # rows per slot of the GPT cache
    nv = small.ctx_k.shape[0]       # rows per slot of the Backpack caches
    gr, br = slice(slot * h, (slot + 1) * h), slice(slot * nv, (slot + 1) * nv)
    for name in ("k", "v", "k_scale", "v_scale"):
        dst = getattr(g_big, name)
        if dst is not None:
            dst[:, gr] = getattr(g_small, name)
    for name in ("ctx_k", "ctx_k_scale", "content", "content_scale"):
        dst = getattr(big, name)
        if dst is not None:
            dst[br] = getattr(small, name)
    n = small.length
    if isinstance(n, torch.Tensor):
        n = n.reshape(-1)[:1]
    g_big.length[slot:slot + 1] = n
    big.length[slot:slot + 1] = n
    if g_big.staged:
        g_big.stage_pos[slot] = -1
        g_big.base_len[slot:slot + 1] = n
    return big


def flush_cache(cache: BackpackCache, window: Optional[int] = None
                ) -> BackpackCache:
    """Merge the staging blocks into the main caches and reset the stage
    (JAX :366), in place: gpt.flush_kv_cache for the KV stack, the same
    indexed writes for the contextualization-key and sense caches. The
    serving engine calls it every ~C decode steps and before steps that
    read the unstaged cache."""
    if not cache.staged:
        return cache
    g = cache.gpt
    b = g.stage_pos.shape[0]
    S = cache.ctx_k.shape[-1]
    w = S if window is None else min(window, S)
    rows, cols, pos = gpt_lib.stage_targets(g.stage_pos, cache.length,
                                            cache.ctx_k.shape[0] // b, w)
    cache.ctx_k[rows, :, pos] = cache.ctx_k_stage[rows, cols]
    cache.content[rows, pos] = cache.content_stage[rows, cols]
    if cache.ctx_k_scale is not None:
        cache.ctx_k_scale[rows, pos] = cache.ctx_ks_stage[rows, cols]
        cache.content_scale[rows, pos] = cache.content_ss_stage[rows, cols]
    gpt_lib.flush_kv_cache(g, window=window)
    return cache


def extract_cache_slot(big: BackpackCache, row: int,
                       cfg: BackpackConfig) -> BackpackCache:
    """Row ``row`` of a batch cache as a batch-1 cache (JAX :417), the
    inverse of insert_cache_slot: views of the row's tensors, no staging
    block. Its length is an int when ``big``'s is, else the (1,) slice of
    the per-slot lengths (reading it as an int would wait on the card)."""
    h, nv = cfg.n_head, cfg.num_senses
    gr, br = slice(row * h, (row + 1) * h), slice(row * nv, (row + 1) * nv)
    g = big.gpt

    def take(t, rows):
        return None if t is None else t[:, rows]

    def length(n):
        return n if isinstance(n, int) else n[row:row + 1]

    gpt_cache = gpt_lib.KVCache(
        k=take(g.k, gr), v=take(g.v, gr), length=length(g.length),
        k_scale=take(g.k_scale, gr), v_scale=take(g.v_scale, gr))
    rows = lambda t: None if t is None else t[br]
    return BackpackCache(
        gpt=gpt_cache, ctx_k=big.ctx_k[br], content=big.content[br],
        length=length(big.length), content_scale=rows(big.content_scale),
        ctx_k_scale=rows(big.ctx_k_scale))


def _weights_es(sense_weights, b: int, nv: int, max_s: int):
    """sense_weights -> (E, max_s) f32 multiplicative key weights (JAX
    :720): (nv,) for every row, (b, nv) per request, or (b, S, nv) per
    position. Contiguous: over a floating-point cache the weights are the
    decode kernels' value scales, read with a unit inner stride (the
    expanded forms, and the per-position one at b = 1, are views
    without)."""
    if sense_weights is None:
        return None
    w = sense_weights.float()
    if w.dim() == 1:
        w = w[None, :, None].expand(b, nv, max_s)
    elif w.dim() == 2:
        w = w[:, :, None].expand(b, nv, max_s)
    else:
        w = w.permute(0, 2, 1)
    return w.reshape(b * nv, max_s).contiguous()


def backpack_forward_with_cache(
    params: Params, cfg: BackpackConfig, input_ids: torch.Tensor,
    cache: BackpackCache, *, window: Optional[int] = None,
    sense_weights: Optional[torch.Tensor] = None,
    sense_edit: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    return_ctx_q: bool = False,
):
    """Run ``input_ids`` (prefill, or decode s == 1) through the
    incremental path: logits (b, s, vocab) for the new tokens. Writes the
    new keys, senses (and scales) into ``cache`` IN PLACE, advances its
    length, and returns it. Over the mixed low-bit cache a decode step
    runs K8; multi-token calls (prefill, continuation) take the prefill
    branch over the dequantized prefix and must start at an even length.
    Per-slot caches write each row at its own offset; on a staged cache a
    step of s <= min(FLAT_MULTI_MAX, C) tokens appends to the staging
    blocks and the combine merges the main segment (K1's (m, l) form) with
    the staged one.

    window: static length bucket (caller-guaranteed length + s <= window);
    every cache read covers only the first ``window`` columns.
    sense_weights: multiplicative per-sense weights on the combine's keys
    (JAX :720): (nv,), (b, nv) per request or (b, S, nv) per position;
    folded into the value scales (unstaged caches only).
    sense_edit: (edited_ids, edited_senses) replacing the new tokens'
    senses before they are cached (unstaged caches only).
    return_ctx_q: also return the new tokens' contextualization queries q
    (b, s, nv, dnv), for the negative-weighted decode's alpha rows
    (JAX :907): (logits, cache, q)."""
    b, s = input_ids.shape
    offset = cache.length
    vec = isinstance(offset, torch.Tensor)
    new_len = offset + s
    nv, d = cfg.num_senses, cfg.n_embd
    dnv, dnv_pad = cfg.sense_head_dim, cfg.sense_head_dim_padded
    e = b * nv
    q4 = cache.bits == 4
    max_s = cache.ctx_k.shape[-1] * (2 if q4 else 1)
    S = max_s if window is None else min(window, max_s)
    staged = cache.staged and vec and s <= min(gpt_lib.FLAT_MULTI_MAX,
                                               cache.ctx_k_stage.shape[1])
    if staged and (sense_weights is not None or sense_edit is not None):
        raise ValueError("a staged step takes no sense weights or edits: "
                         "flush and step the unstaged cache (the serving "
                         "engine's plain view)")
    if q4 and s > 1 and vec:
        raise ValueError("int4 caches take multi-token writes at a uniform "
                         "(scalar) offset only")
    if q4 and not vec:
        gpt_lib.check_even_offset(offset, s)
    row_off = gpt_lib.per_row(offset, nv) if vec else offset
    lens = gpt_lib.per_row(new_len, nv) if vec else new_len
    ptr0 = cache.gpt.stage_ptr
    contextl, gpt_cache = gpt_lib.gpt_forward_with_cache(
        params["gpt"], cfg, input_ids, cache.gpt, window=window)
    q, k_new = context_qk(params, cfg, contextl)       # (b, s, nv, dnv)
    senses_new = content_forward(params, cfg, input_ids)  # (b, s, nv, d)
    if sense_edit is not None:
        senses_new = apply_sense_edit(senses_new, input_ids, sense_edit)
    senses_t = senses_new.transpose(1, 2).reshape(e, s, d)
    if staged:
        # append at the stage pointer the GPT write started from
        cols = slice(ptr0, ptr0 + s)
        k_st = k_new.transpose(1, 2).reshape(e, s, dnv)
        if dnv_pad != dnv:
            k_st = torch.nn.functional.pad(k_st, (0, dnv_pad - dnv))
        if cache.quantized:
            k8, kss = quant.quantize_activations_int8(k_st, axis=2)
            s8, sss = quant.quantize_activations_int8(senses_t, axis=2)
            cache.ctx_k_stage[:, cols] = k8
            cache.content_stage[:, cols] = s8
            cache.ctx_ks_stage[:, cols] = kss[..., 0]
            cache.content_ss_stage[:, cols] = sss[..., 0]
        else:
            cache.ctx_k_stage[:, cols] = k_st.to(cache.ctx_k_stage.dtype)
            cache.content_stage[:, cols] = senses_t.to(cache.content_stage.dtype)
    else:
        k_flat = k_new.permute(0, 2, 3, 1).reshape(e, dnv, s)
        if dnv_pad != dnv:
            k_flat = torch.nn.functional.pad(k_flat, (0, 0, 0, dnv_pad - dnv))
        if q4:
            # int8 keys into the even/odd split planes, int4 senses
            # pair-packed
            k8, ksc = quant.quantize_activations_int8(k_flat, axis=1)
            s4, ssc = quant.quantize_activations_int4(senses_t, axis=2)
            if s == 1:
                gpt_lib.store_split8_step(cache.ctx_k, k8, row_off, window)
                gpt_lib.rmw_nibble_axis_windowed(cache.content, s4, row_off,
                                                 1, window)
                gpt_lib.update_pair_scale(cache.ctx_k_scale, ksc[:, 0, 0],
                                          row_off, window)
                gpt_lib.update_pair_scale(cache.content_scale, ssc[:, 0, 0],
                                          row_off, window)
            else:
                k8p = torch.nn.functional.pad(k8, (0, s % 2))
                c0, n2 = offset // 2, k8p.shape[-1] // 2
                cache.ctx_k[..., c0:c0 + n2] = torch.stack(
                    [k8p[..., 0::2], k8p[..., 1::2]], dim=2)
                gpt_lib.store4_prefill(cache.content, s4, offset, axis=1)
                gpt_lib.store_pair_scale(cache.ctx_k_scale, ksc[:, 0, :],
                                         offset)
                gpt_lib.store_pair_scale(cache.content_scale, ssc[..., 0],
                                         offset)
        elif cache.quantized:
            k8, ksc = quant.quantize_activations_int8(k_flat, axis=1)
            s8, ssc = quant.quantize_activations_int8(senses_t, axis=2)
            write = gpt_lib.update_rows_axis_windowed
            write(cache.ctx_k, k8, row_off, 2, window)
            write(cache.ctx_k_scale, ksc[:, 0, :], row_off, 1, window)
            write(cache.content, s8, row_off, 1, window)
            write(cache.content_scale, ssc[..., 0], row_off, 1, window)
        else:
            gpt_lib.update_rows_axis_windowed(cache.ctx_k, k_flat, row_off, 2,
                                              window)
            gpt_lib.update_rows_axis_windowed(cache.content, senses_t,
                                              row_off, 1, window)

    scale = cfg.sense_head_dim ** -0.5
    w = _weights_es(sense_weights, b, nv, max_s)
    if q4:
        S2 = -(-S // 2)
        ctx_k_r, content_r = cache.ctx_k[..., :S2], cache.content[:, :S2]
        ks_r, vs = cache.ctx_k_scale[..., :S2], cache.content_scale[..., :S2]
        if w is not None and s == 1:
            # (E, S) per-position weights -> the (E, 2, S/2) parity layout
            vs = vs * w.reshape(e, -1, 2).transpose(1, 2)[..., :S2]
    else:
        ctx_k_r, content_r = cache.ctx_k[:, :, :S], cache.content[:, :S]
        ks_r = cache.ctx_k_scale[:, :S] if cache.quantized else None
        vs = cache.content_scale[:, :S] if cache.quantized else None
        if w is not None and s <= gpt_lib.FLAT_MULTI_MAX:
            vs = w[:, :S] if vs is None else vs * w[:, :S]
    if s <= gpt_lib.FLAT_MULTI_MAX and (s == 1 or not q4):
        # ONE pass over the stored-precision caches: per-sense softmax over
        # the cached keys and the weighted sense sum (K1 when s == 1, K8
        # over the mixed cache; on a staged cache K1's (m, l) form merged
        # with the staged segment)
        q_s = (q.float() * scale).to(q.dtype)
        if dnv_pad != dnv:
            q_s = torch.nn.functional.pad(q_s, (0, dnv_pad - dnv))
        q_flat = q_s.transpose(1, 2).reshape(e, s, dnv_pad)
        if staged:
            g = gpt_cache
            stage = (gpt_lib.per_row(g.base_len, nv), cache.ctx_k_stage,
                     cache.ctx_ks_stage, cache.content_stage,
                     cache.content_ss_stage, gpt_lib.per_row(g.stage_pos, nv),
                     lens)
            if s == 1:
                out = decode_attention_staged(
                    q_flat[:, 0].contiguous(), ctx_k_r, ks_r, content_r, vs,
                    *stage)[:, None]
            else:
                out = decode_attention_flat_multi_staged(
                    q_flat, ctx_k_r, ks_r, content_r, vs, *stage)
        elif s == 1:
            decode = decode_attention_mixed if q4 else decode_attention
            out = decode(q_flat[:, 0].contiguous(), ctx_k_r, ks_r, content_r,
                         vs, lens)[:, None]
        else:
            out = decode_attention_flat_multi(q_flat, ctx_k_r, ks_r,
                                              content_r, vs, lens)
        outputs = out.reshape(b, nv, s, d).float().sum(dim=1).to(contextl.dtype)
    else:
        # prefill: materialize the alpha rows of the s new queries
        if q4:
            # dequantize the low-bit prefix once: keys re-interleave from
            # the split planes, senses unpack
            S = 2 * content_r.shape[1]
            ctx_k_r = (ctx_k_r.transpose(2, 3).reshape(e, dnv_pad, S).float()
                       * quant.interleave_pair_scales(ks_r)[:, None, :]
                       ).to(contextl.dtype)
            content_r = gpt_lib.dequantize_pairs(content_r, vs, 1,
                                                 contextl.dtype)
        fold8 = cache.quantized and not q4
        ctx_k4 = ctx_k_r.reshape(b, nv, dnv_pad, S)
        content4 = content_r.reshape(b, nv, S, d)
        q_pad = (torch.nn.functional.pad(q, (0, dnv_pad - dnv))
                 if dnv_pad != dnv else q)
        scores = torch.einsum("bthd,bhds->bhts", q_pad.float(),
                              ctx_k4.to(q.dtype).float() * scale)
        if fold8:
            scores = scores * ks_r.reshape(b, nv, S)[:, :, None, :]
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(S, device=q.device)[None, :]
        if vec:
            causal = kpos[None] <= qpos[None] + offset[:, None, None]
            scores = torch.where(causal[:, None], scores, MASK_VALUE)
        else:
            scores = torch.where((kpos <= qpos + offset)[None, None], scores,
                                 MASK_VALUE)
        alpha = torch.softmax(scores, dim=-1).to(contextl.dtype)
        if fold8:
            alpha = alpha * vs.reshape(b, nv, S)[:, :, None, :].to(alpha.dtype)
        if w is not None:
            alpha = alpha * w.reshape(b, nv, max_s)[:, :, None, :S].to(
                alpha.dtype)
        outputs = torch.einsum("bkts,bksd->btd", alpha.float(),
                               content4.to(contextl.dtype).float()
                               ).to(contextl.dtype)
    logits = gpt_lib.lm_logits(params["gpt"], cfg, outputs)
    cache.length = new_len
    if return_ctx_q:
        return logits, cache, q
    return logits, cache


# ---------------------------------------------------------------- module

def _flatten(tree, prefix: str, out: Dict[str, torch.Tensor]):
    """Tree -> skeleton whose tensor leaves are replaced by buffer names."""
    if isinstance(tree, dict):
        return {k: _flatten(v, f"{prefix}__{k}", out) for k, v in tree.items()}
    if isinstance(tree, (quant.QuantWeight, quant.QuantTable)):
        fields = {f.name: getattr(tree, f.name)
                  for f in dataclasses.fields(tree)}
        return dataclasses.replace(tree, **{
            k: _flatten(v, f"{prefix}__{k}", out) for k, v in fields.items()
            if isinstance(v, torch.Tensor)})
    if isinstance(tree, torch.Tensor):
        out[prefix.lstrip("_")] = tree
        return prefix.lstrip("_")
    return tree


def _rebuild(skel, module: torch.nn.Module):
    if isinstance(skel, dict):
        return {k: _rebuild(v, module) for k, v in skel.items()}
    if isinstance(skel, (quant.QuantWeight, quant.QuantTable)):
        return dataclasses.replace(skel, **{
            f.name: _rebuild(getattr(skel, f.name), module)
            for f in dataclasses.fields(skel)
            if isinstance(getattr(skel, f.name), str)})
    if isinstance(skel, str):
        return getattr(module, skel)
    return skel


class BackpackLM(torch.nn.Module):
    """Thin module over the functional model: registers the parameter
    tree's floating-point tensors as ``nn.Parameter``s (trainable; what
    ``parameters()``, ``.to()`` and ``state_dict()`` see) and the integer
    ones of a quantized tree as buffers, and calls the functions above with
    the tree rebuilt from them."""

    def __init__(self, cfg: BackpackConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        tensors: Dict[str, torch.Tensor] = {}
        self._skeleton = _flatten(params, "", tensors)
        for name, t in tensors.items():
            if t.is_floating_point():
                self.register_parameter(name, torch.nn.Parameter(t.detach()))
            else:
                self.register_buffer(name, t)

    @property
    def params(self) -> Params:
        return _rebuild(self._skeleton, self)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, input_ids: torch.Tensor, **kw):
        """``backpack_forward`` (train=, rng=, fused_ctx=, ... pass through)."""
        return backpack_forward(self.params, self.cfg, input_ids, **kw)

    def init_cache(self, batch: int, max_seqlen: int, dtype=torch.bfloat16,
                   **kw) -> BackpackCache:
        """``init_backpack_cache`` on the module's device (bits=,
        kv_bits=, per_slot=, stage= pass through)."""
        return init_backpack_cache(self.cfg, batch, max_seqlen, dtype,
                                   device=self.device, **kw)

    @torch.no_grad()
    def step(self, input_ids: torch.Tensor, cache: BackpackCache,
             window: Optional[int] = None, **kw):
        """One cached prefill or decode step (cache updated in place;
        sense_weights= passes through)."""
        return backpack_forward_with_cache(self.params, self.cfg, input_ids,
                                           cache, window=window, **kw)

    def generate(self, input_ids: torch.Tensor, max_length: int, **kw):
        from ..utils.generation import generate_backpack
        return generate_backpack(self.params, self.cfg, input_ids, max_length,
                                 device=self.device, **kw)

    @torch.no_grad()
    def quantized(self, bits: int = 8) -> "BackpackLM":
        from .quantized import quantize_backpack_params
        return BackpackLM(self.cfg, quantize_backpack_params(
            self.params, self.cfg, bits=bits))
