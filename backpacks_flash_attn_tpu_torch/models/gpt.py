"""GPT-2 style decoder (PyTorch port): training forward and inference.

Port of ``backpacks_flash_attn_tpu/models/gpt.py``: pure functions over a
dict of tensors in the JAX tree layout (kernels ``(in, out)``, layers
stacked on a leading ``n_layer`` axis), the reordered residual
("Attn/MLP -> Add -> LN", final LN as the last layer's norm2, first LN
hoisted to ``ln_0``), the f32 residual stream, and the flat-E KV cache.
Where JAX scans over layers, the port loops. In training the dropout keys
split as in JAX (``utils.prng``), so every mask is JAX's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..config import GPTConfig
from ..ops import _build, dense, norms, quant
from ..ops.attention import mha
from ..utils import prng
from ..ops.decode_attention import (decode_attention,
                                    decode_attention_flat_multi,
                                    decode_attention_int4)

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
    if cfg.moe_experts or cfg.rotary_emb_dim or cfg.attn_dwconv:
        raise NotImplementedError("MoE, rotary and dwconv GPT variants are "
                                  "not ported yet")


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


def embed(params: Params, cfg: GPTConfig, input_ids: torch.Tensor,
          position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Word + learned-position embeddings."""
    hidden = take_embedding(params["wte"], input_ids, quant_act_dtype(params))
    if cfg.n_positions > 0:
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None, :]
        hidden = hidden + params["wpe"][position_ids].to(hidden.dtype)
    return hidden


# ---------------------------------------------------------------- forward

def _mlp_and_norms(hidden, residual, lp, mixer_out, cfg, *,
                   train: bool = False, r_d1=None, r_d2=None):
    det = not train
    hidden, residual = norms.dropout_add_layer_norm(
        mixer_out, residual, lp["norm1"]["weight"], lp["norm1"]["bias"],
        cfg.resid_pdrop, cfg.layer_norm_epsilon, rng=r_d1, deterministic=det)
    mlp_out = dense.mlp(hidden, lp["mlp"], cfg.activation)
    return norms.dropout_add_layer_norm(
        mlp_out, residual, lp["norm2"]["weight"], lp["norm2"]["bias"],
        cfg.resid_pdrop, cfg.layer_norm_epsilon, rng=r_d2, deterministic=det)


def check_remat(remat) -> None:
    """Only "none" (save everything) is ported; the JAX package's
    rematerialization modes wait for ROADMAP Queue 1 item 6."""
    if remat not in (False, None, "none"):
        raise NotImplementedError(f"remat={remat!r} is not ported yet "
                                  f"(ROADMAP Queue 1 item 6)")


def _block(hidden, residual, lp, scale, cfg: GPTConfig, *, train: bool,
           rngs):
    """One pre-norm block with the reordered residual (JAX ``_block`` :372):
    attention dropout in the flash kernel, then two dropout+add+LN sites,
    keyed by the three splits of the layer's key."""
    b, s, _ = hidden.shape
    qkv = dense.linear(hidden, lp["Wqkv"])
    qkv = qkv.reshape(b, s, 3, cfg.n_head, cfg.head_dim)
    r_attn, r_d1, r_d2 = (prng.split(rngs, 3) if rngs is not None
                          else (None, None, None))
    ctx = mha(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=True,
              softmax_scale=scale, dropout_p=cfg.attn_pdrop,
              dropout_rng=r_attn, deterministic=not train)
    mixer_out = dense.linear(ctx.reshape(b, s, cfg.n_embd), lp["out_proj"])
    return _mlp_and_norms(hidden, residual, lp, mixer_out, cfg, train=train,
                          r_d1=r_d1, r_d2=r_d2)


def gpt_forward(params: Params, cfg: GPTConfig, input_ids: torch.Tensor, *,
                train: bool = False, rng: Optional[torch.Tensor] = None,
                remat="none") -> torch.Tensor:
    """Full forward -> post-final-LN hidden states (b, s, d) (JAX
    ``gpt_forward`` :470). Attention goes through the flash wrapper (K3
    forward, K5 backward); the JAX package's ``use_flash=False`` reference
    attention is not a path of the port. train with a key
    ``rng`` (``utils.prng``) turns on the dropout sites: the embedding's,
    and per layer the attention's and the two residual ones."""
    _check_supported(cfg)
    check_remat(remat)
    hidden = embed(params, cfg, input_ids)
    r_emb, r_layers = prng.split(rng) if rng is not None else (None, None)
    hidden, residual = norms.dropout_add_layer_norm(
        hidden, None, params["ln_0"]["weight"], params["ln_0"]["bias"],
        cfg.embd_pdrop, cfg.layer_norm_epsilon, rng=r_emb,
        deterministic=not train)
    layer_rngs = (prng.split(r_layers, cfg.n_layer) if r_layers is not None
                  else None)
    for li, scale in enumerate(_softmax_scales(cfg)):
        hidden, residual = _block(
            hidden, residual, tree_index(params["layers"], li), scale, cfg,
            train=train, rngs=None if layer_rngs is None else layer_rngs[li])
    return hidden


# ---------------------------------------------------------------- KV cache

@dataclasses.dataclass
class KVCache:
    """Static-shape KV cache, stacked over layers, in the flat-E layout of
    the decode contraction (E = batch * n_head):

      k:       (n_layer, E, head_dim, max_seqlen) — TRANSPOSED keys
      v:       (n_layer, E, max_seqlen, head_dim)
      k_scale/v_scale: (n_layer, E, max_seqlen) f32 dequant scales (int8)
      length:  number of valid positions (a Python int: uniform batch)

    int4 caches pack positions pairwise (ops/quant.py): k (n_layer, E,
    head_dim, max_seqlen/2), v (n_layer, E, max_seqlen/2, head_dim), scales
    (n_layer, E, 2, max_seqlen/2).

    The cache functions update these tensors IN PLACE (JAX returns new
    ones); callers that need the old state copy it first."""
    k: torch.Tensor
    v: torch.Tensor
    length: int
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

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


def init_kv_cache(cfg: GPTConfig, batch: int, max_seqlen: int,
                  dtype=torch.bfloat16, device="cuda", *,
                  bits: int = 8) -> KVCache:
    """dtype int8 stores INT8 caches with per-position f32 scales; with
    bits=4 as well, int4 caches pair-packed along positions (max_seqlen
    even), scales in the (E, 2, S/2) parity layout. Decode steps write a
    nibble in place; multi-token writes must start at an even length."""
    device = _build.resolve_device(device)
    L, e, dh, S = cfg.n_layer, batch * cfg.n_head, cfg.head_dim, max_seqlen
    if dtype == torch.int8 and bits == 4:
        if S % 2:
            raise ValueError(f"int4 caches need an even max_seqlen, got {S}")
        ones = lambda: torch.ones((L, e, 2, S // 2), dtype=torch.float32,
                                  device=device)
        return KVCache(
            k=torch.zeros((L, e, dh, S // 2), dtype=dtype, device=device),
            v=torch.zeros((L, e, S // 2, dh), dtype=dtype, device=device),
            length=0, k_scale=ones(), v_scale=ones())
    k_scale = v_scale = None
    if dtype == torch.int8:
        k_scale = torch.ones((L, e, S), dtype=torch.float32, device=device)
        v_scale = torch.ones((L, e, S), dtype=torch.float32, device=device)
    return KVCache(k=torch.zeros((L, e, dh, S), dtype=dtype, device=device),
                   v=torch.zeros((L, e, S, dh), dtype=dtype, device=device),
                   length=0, k_scale=k_scale, v_scale=v_scale)


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

    window: static upper bound on the valid length after this call
    (caller-guaranteed length + s <= window); attention reads only the
    first ``window`` cache columns (int4: ceil(window / 2) packed
    columns)."""
    _check_supported(cfg)
    b, s = input_ids.shape
    offset = cache.length
    new_len = offset + s
    q4 = cache.bits == 4
    S_all = cache.k.shape[-1] * (2 if q4 else 1)
    if new_len > S_all or (window is not None and new_len > window):
        raise ValueError(f"cache overflow: length {offset} + {s} exceeds "
                         f"max {S_all} / window {window}")
    if q4:
        check_even_offset(offset, s)
    W = S_all if window is None else min(window, S_all)
    W2 = -(-W // 2)                     # int4: packed columns of the window
    dev = input_ids.device
    position_ids = offset + torch.arange(s, device=dev)[None, :]
    hidden = embed(params, cfg, input_ids, position_ids)
    hidden, residual = norms.dropout_add_layer_norm(
        hidden, None, params["ln_0"]["weight"], params["ln_0"]["bias"],
        0.0, cfg.layer_norm_epsilon)
    h, dk = cfg.n_head, cfg.head_dim
    e = b * h
    for li, scale in enumerate(_softmax_scales(cfg)):
        lp = tree_index(params["layers"], li)
        qkv = dense.linear(hidden, lp["Wqkv"]).reshape(b, s, 3, h, dk)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        kt_new = k.permute(0, 2, 3, 1).reshape(e, dk, s)
        v_new = v.transpose(1, 2).reshape(e, s, dk)
        if q4:
            k4q, ks = quant.quantize_activations_int4(kt_new, axis=1)
            v4q, vs = quant.quantize_activations_int4(v_new, axis=2)
            store = store4_step if s == 1 else store4_prefill
            store(cache.k[li], k4q, offset, axis=2)
            store(cache.v[li], v4q, offset, axis=1)
            store_pair_scale(cache.k_scale[li], ks[:, 0, :], offset)
            store_pair_scale(cache.v_scale[li], vs[..., 0], offset)
        elif cache.quantized:
            k8, ks = quant.quantize_activations_int8(kt_new, axis=1)
            v8, vs = quant.quantize_activations_int8(v_new, axis=2)
            cache.k[li, :, :, offset:new_len] = k8
            cache.v[li, :, offset:new_len] = v8
            cache.k_scale[li, :, offset:new_len] = ks[:, 0, :]
            cache.v_scale[li, :, offset:new_len] = vs[..., 0]
        else:
            cache.k[li, :, :, offset:new_len] = kt_new
            cache.v[li, :, offset:new_len] = v_new
        if q4:
            kt_c, v_c = cache.k[li, :, :, :W2], cache.v[li, :, :W2]
            k_sc, v_sc = cache.k_scale[li, ..., :W2], cache.v_scale[li, ..., :W2]
        else:
            kt_c, v_c = cache.k[li, :, :, :W], cache.v[li, :, :W]
            k_sc = cache.k_scale[li, :, :W] if cache.quantized else None
            v_sc = cache.v_scale[li, :, :W] if cache.quantized else None
        if s == 1:
            q_flat = (q[:, 0].float() * scale).to(q.dtype).reshape(e, dk)
            decode = decode_attention_int4 if q4 else decode_attention
            ctx = decode(q_flat, kt_c, k_sc, v_c, v_sc, new_len)
            ctx = ctx.reshape(b, 1, h, dk)
        elif s <= FLAT_MULTI_MAX and not q4:
            qf = (q.float() * scale).to(q.dtype)
            q_flat = qf.transpose(1, 2).reshape(e, s, dk)
            ctx = decode_attention_flat_multi(q_flat, kt_c, k_sc, v_c, v_sc,
                                              new_len)
            ctx = ctx.reshape(b, h, s, dk).transpose(1, 2)
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
            lens = torch.full((b,), new_len, dtype=torch.int32, device=dev)
            ctx = mha(q, kd, vd, causal=True, softmax_scale=scale,
                      seq_lengths=lens, q_offset=offset)
        mixer_out = dense.linear(ctx.reshape(b, s, cfg.n_embd), lp["out_proj"])
        hidden, residual = _mlp_and_norms(hidden, residual, lp, mixer_out,
                                          cfg)
    cache.length = new_len
    return hidden, cache


# ---------------------------------------------------------------- LM head

def lm_logits(params: Params, cfg: GPTConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Tied lm_head: hidden @ wte^T, in hidden's dtype. Quantized trees
    carry an explicit quantized (d, V) 'lm_head' and return f32 logits."""
    if "lm_head" in params:
        return quant.quant_linear(hidden, params["lm_head"]).float()
    wte = params["wte"]
    if hidden.dtype == torch.bfloat16 and wte.dtype == torch.bfloat16:
        return hidden @ wte.T
    return (hidden.float() @ wte.float().T).to(hidden.dtype)


def gpt_lm_forward(params: Params, cfg: GPTConfig, input_ids: torch.Tensor,
                   **kw) -> torch.Tensor:
    """GPT LM with the tied head: logits (b, s, V) (JAX :1127)."""
    return lm_logits(params, cfg, gpt_forward(params, cfg, input_ids, **kw))
