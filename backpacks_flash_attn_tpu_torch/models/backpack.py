"""Backpack language model (PyTorch port), inference.

Port of ``backpacks_flash_attn_tpu/models/backpack.py``:

    o_t = sum_{k=1..nv} sum_{j<=t} alpha[k, t, j] * C(x_j)[k],
    logits_t = E @ o_t  (E = tied word embedding)

The contextualization network is the GPT stack of ``models/gpt.py``; the
sense network is per-token (word embeddings, no positions, one MLP-only
block, a d -> nv*d MLP), so a quantized tree may replace it by a gathered
(vocab, nv, d) table. Decode is incremental: GPT KV cache + cached
contextualization keys + cached senses, computing one alpha row per step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..config import BackpackConfig
from ..ops import _build, dense, norms, quant
from ..ops.attention import MASK_VALUE
from ..ops.backpack_kernels import fused_contextualization
from ..ops.decode_attention import decode_attention, decode_attention_flat_multi
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
               hidden: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contextualization hidden states -> nv-headed q, k, each
    (b, s, nv, d/nv)."""
    b, s, d = hidden.shape
    qk = dense.linear(hidden, params["ctx_attn"]["Wqkv"])
    qk = qk.reshape(b, s, 2, cfg.num_senses, cfg.sense_head_dim)
    return qk[:, :, 0], qk[:, :, 1]


def contextualization(params: Params, cfg: BackpackConfig,
                      hidden: torch.Tensor) -> torch.Tensor:
    """alpha = causal softmax over nv-headed scores, materialized
    (b, nv, s, s) in hidden's dtype (the return_parts path)."""
    q, k = context_qk(params, cfg, hidden)
    scale = cfg.sense_head_dim ** -0.5
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float() * scale)
    s = scores.shape[-1]
    pos = torch.arange(s, device=hidden.device)
    scores = scores + torch.where(pos[None, :] <= pos[:, None], 0.0,
                                  MASK_VALUE)[None, None]
    return torch.softmax(scores, dim=-1).to(hidden.dtype)


def content_forward(params: Params, cfg: BackpackConfig,
                    input_ids: torch.Tensor) -> torch.Tensor:
    """Sense network C(x): (b, s) -> (b, s, nv, d); strictly per-token. A
    quantized tree with a precomputed sense table gathers from it."""
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
    hidden = gpt_lib.take_embedding(params["gpt"]["wte"], input_ids, act)
    hidden, residual = norms.dropout_add_layer_norm(
        hidden, None, cp["ln_0"]["weight"], cp["ln_0"]["bias"],
        0.0, cfg.layer_norm_epsilon)
    n_blocks = cp["blocks"]["norm1"]["weight"].shape[0]
    for i in range(n_blocks):
        blk = gpt_lib.tree_index(cp["blocks"], i)
        # no-mix block: the identity mixer still feeds `hidden` into the
        # residual stream
        hidden, residual = norms.dropout_add_layer_norm(
            hidden, residual, blk["norm1"]["weight"], blk["norm1"]["bias"],
            0.0, cfg.layer_norm_epsilon)
        mlp_out = dense.mlp(hidden, blk["mlp"], cfg.activation)
        hidden, residual = norms.dropout_add_layer_norm(
            mlp_out, residual, blk["norm2"]["weight"], blk["norm2"]["bias"],
            0.0, cfg.layer_norm_epsilon)
    senses = dense.mlp(hidden, cp["final_mlp"], cfg.activation)
    return senses.reshape(b, s, cfg.num_senses, cfg.n_embd)


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

def backpack_forward(params: Params, cfg: BackpackConfig,
                     input_ids: torch.Tensor, *, return_parts: bool = False):
    """Inference forward -> logits (b, s, vocab). The GPT attention goes
    to K3 and the contextualization to K4 (alpha is never stored);
    return_parts takes the einsum path and also returns
    {'alpha', 'content', 'contextual', 'outputs'}."""
    contextl = gpt_lib.gpt_forward(params["gpt"], cfg, input_ids)
    content = content_forward(params, cfg, input_ids)          # (b, s, nv, d)
    scale = cfg.sense_head_dim ** -0.5
    alpha = None
    if not return_parts:
        q, ctx_k = context_qk(params, cfg, contextl)
        outputs = fused_contextualization(q, ctx_k, content,
                                          scale).to(contextl.dtype)
    else:
        alpha = contextualization(params, cfg, contextl)
        outputs = torch.einsum("bkts,bskd->btd", alpha.float(),
                               content.float()).to(contextl.dtype)
    logits = gpt_lib.lm_logits(params["gpt"], cfg, outputs)
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

    Updated IN PLACE by backpack_forward_with_cache (JAX returns new
    caches); copy the tensors before a call whose old state you need."""
    gpt: gpt_lib.KVCache
    ctx_k: torch.Tensor
    content: torch.Tensor
    length: int
    content_scale: Optional[torch.Tensor] = None
    ctx_k_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.content.dtype == torch.int8


def init_backpack_cache(cfg: BackpackConfig, batch: int, max_seqlen: int,
                        dtype=torch.bfloat16, device="cuda") -> BackpackCache:
    """dtype int8: INT8 GPT-KV, ctx-K and sense caches with per-position
    f32 scales (the int4 caches come with the low-bit slice)."""
    device = _build.resolve_device(device)
    e, S = batch * cfg.num_senses, max_seqlen
    scales = dtype == torch.int8
    ones = lambda: torch.ones((e, S), dtype=torch.float32, device=device)
    return BackpackCache(
        gpt=gpt_lib.init_kv_cache(cfg, batch, max_seqlen, dtype, device),
        ctx_k=torch.zeros((e, cfg.sense_head_dim_padded, S), dtype=dtype,
                          device=device),
        content=torch.zeros((e, S, cfg.n_embd), dtype=dtype, device=device),
        length=0,
        content_scale=ones() if scales else None,
        ctx_k_scale=ones() if scales else None,
    )


def backpack_forward_with_cache(
    params: Params, cfg: BackpackConfig, input_ids: torch.Tensor,
    cache: BackpackCache, *, window: Optional[int] = None,
) -> Tuple[torch.Tensor, BackpackCache]:
    """Run ``input_ids`` (prefill, or decode s == 1) through the
    incremental path: logits (b, s, vocab) for the new tokens. Writes the
    new keys, senses (and scales) into ``cache`` IN PLACE, advances its
    length, and returns it.

    window: static length bucket (caller-guaranteed length + s <= window);
    every cache read covers only the first ``window`` columns."""
    b, s = input_ids.shape
    offset = cache.length
    new_len = offset + s
    nv, d = cfg.num_senses, cfg.n_embd
    dnv, dnv_pad = cfg.sense_head_dim, cfg.sense_head_dim_padded
    e = b * nv
    max_s = cache.ctx_k.shape[-1]
    S = max_s if window is None else min(window, max_s)
    contextl, _ = gpt_lib.gpt_forward_with_cache(
        params["gpt"], cfg, input_ids, cache.gpt, window=window)
    q, k_new = context_qk(params, cfg, contextl)       # (b, s, nv, dnv)
    senses_new = content_forward(params, cfg, input_ids)  # (b, s, nv, d)
    senses_t = senses_new.transpose(1, 2).reshape(e, s, d)
    k_flat = k_new.permute(0, 2, 3, 1).reshape(e, dnv, s)
    if dnv_pad != dnv:
        k_flat = torch.nn.functional.pad(k_flat, (0, 0, 0, dnv_pad - dnv))
    if cache.quantized:
        k8, ksc = quant.quantize_activations_int8(k_flat, axis=1)
        s8, ssc = quant.quantize_activations_int8(senses_t, axis=2)
        cache.ctx_k[:, :, offset:new_len] = k8
        cache.ctx_k_scale[:, offset:new_len] = ksc[:, 0, :]
        cache.content[:, offset:new_len] = s8
        cache.content_scale[:, offset:new_len] = ssc[..., 0]
    else:
        cache.ctx_k[:, :, offset:new_len] = k_flat
        cache.content[:, offset:new_len] = senses_t

    scale = cfg.sense_head_dim ** -0.5
    ctx_k_r, content_r = cache.ctx_k[:, :, :S], cache.content[:, :S]
    ks_r = cache.ctx_k_scale[:, :S] if cache.quantized else None
    vs = cache.content_scale[:, :S] if cache.quantized else None
    if s <= gpt_lib.FLAT_MULTI_MAX:
        # ONE pass over the stored-precision caches: per-sense softmax over
        # the cached keys and the weighted sense sum (K1 when s == 1)
        q_s = (q.float() * scale).to(q.dtype)
        if dnv_pad != dnv:
            q_s = torch.nn.functional.pad(q_s, (0, dnv_pad - dnv))
        q_flat = q_s.transpose(1, 2).reshape(e, s, dnv_pad)
        if s == 1:
            out = decode_attention(q_flat[:, 0].contiguous(), ctx_k_r, ks_r,
                                   content_r, vs, new_len)[:, None]
        else:
            out = decode_attention_flat_multi(q_flat, ctx_k_r, ks_r,
                                              content_r, vs, new_len)
        outputs = out.reshape(b, nv, s, d).float().sum(dim=1).to(contextl.dtype)
    else:
        # prefill: materialize the alpha rows of the s new queries
        ctx_k4 = ctx_k_r.reshape(b, nv, dnv_pad, S)
        content4 = content_r.reshape(b, nv, S, d)
        q_pad = (torch.nn.functional.pad(q, (0, dnv_pad - dnv))
                 if dnv_pad != dnv else q)
        scores = torch.einsum("bthd,bhds->bhts", q_pad.float(),
                              ctx_k4.to(q.dtype).float() * scale)
        if cache.quantized:
            scores = scores * ks_r.reshape(b, nv, S)[:, :, None, :]
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(S, device=q.device)[None, :]
        scores = torch.where((kpos <= qpos + offset)[None, None], scores,
                             MASK_VALUE)
        alpha = torch.softmax(scores, dim=-1).to(contextl.dtype)
        if cache.quantized:
            alpha = alpha * vs.reshape(b, nv, S)[:, :, None, :].to(alpha.dtype)
        outputs = torch.einsum("bkts,bksd->btd", alpha.float(),
                               content4.to(contextl.dtype).float()
                               ).to(contextl.dtype)
    logits = gpt_lib.lm_logits(params["gpt"], cfg, outputs)
    cache.length = new_len
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
    tree's tensors as buffers (so ``.to()``/``state_dict()`` see them) and
    calls the functions above with the tree rebuilt from them."""

    def __init__(self, cfg: BackpackConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        tensors: Dict[str, torch.Tensor] = {}
        self._skeleton = _flatten(params, "", tensors)
        for name, t in tensors.items():
            self.register_buffer(name, t)

    @property
    def params(self) -> Params:
        return _rebuild(self._skeleton, self)

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device

    def forward(self, input_ids: torch.Tensor, **kw):
        return backpack_forward(self.params, self.cfg, input_ids, **kw)

    def init_cache(self, batch: int, max_seqlen: int,
                   dtype=torch.bfloat16) -> BackpackCache:
        return init_backpack_cache(self.cfg, batch, max_seqlen, dtype,
                                   device=self.device)

    def step(self, input_ids: torch.Tensor, cache: BackpackCache,
             window: Optional[int] = None):
        """One cached prefill or decode step (cache updated in place)."""
        return backpack_forward_with_cache(self.params, self.cfg, input_ids,
                                           cache, window=window)

    def generate(self, input_ids: torch.Tensor, max_length: int, **kw):
        from ..utils.generation import generate_backpack
        return generate_backpack(self.params, self.cfg, input_ids, max_length,
                                 device=self.device, **kw)

    def quantized(self, bits: int = 8) -> "BackpackLM":
        from .quantized import quantize_backpack_params
        return BackpackLM(self.cfg, quantize_backpack_params(
            self.params, self.cfg, bits=bits))
