"""Latency-optimized tensor-parallel Backpack decode over a ('data', 'model')
mesh.

Port of ``backpacks_flash_attn_tpu/parallel/tp_decode.py``. JAX runs the
step in one ``shard_map``; here every rank is a process and runs the same
body on its own shards:

  * slots shard over 'data' (no collectives); weights shard over 'model'
    Megatron-style: Wqkv and fc1 column-parallel, out_proj and fc2
    row-parallel, the word embedding and the tied head vocab-sharded, the
    contextualization heads and the INT8 sense table sense-sharded;
  * every all-reduce is a ring (``ring_psum``): tp - 1 hops over the
    'model' ring of ``parallel/mesh.py``, each posted
    (``start_exchange``) before the work that overlaps it and waited for
    (``finish_exchange``) after;
  * the local slots are split into two microbatches whose phases are
    staggered: while microbatch A's partial sums ride the ring, microbatch
    B's next phase (attention, MLP or the Backpack tail) runs. 3 of the 4
    rings a layer overlap compute this way.

The attention of both parts is K1 (``ops/decode_attention.decode_attention``)
on this rank's rows: its head shard of the GPT cache (E = b_mb * h / tp,
dk = dv = head_dim) and its sense shard of the Backpack caches (E = b_mb *
nv / tp, dv = n_embd), read through strided views of the layer-stacked
buffers, the window folded into the one slice. The INT8 shard products
(and the tied head from the INT8 wte shard) are K2
(``ops/quant.quant_matmul``), which emits bf16, so the row-parallel
partials ride the ring rounded to bf16 where JAX keeps them in f32. Both
run their plain versions on CPU tensors and inside ``_build.plain_path()``.

torch has one process a rank, so the step takes and returns this rank's
rows: tokens (b_loc, 1) of its data shard (``mesh.data_rows`` cuts them
from a global batch), logits (b_loc, 1, V) all-gathered over 'model'. The
cache is this rank's (``prepare``) and is updated in place (JAX donates
it).

Cache layout: unlike the single-device flat-E caches (E = batch * heads,
batch-major), the TP cache keeps batch and heads as separate axes, so
heads and senses shard over 'model' while batch shards over 'data';
``to_tp_cache`` / ``from_tp_cache`` convert without loss.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch

from ..config import BackpackConfig
from ..models import backpack as bp
from ..models import gpt as gpt_lib
from ..ops import dense, norms, quant, rotary
from ..ops.decode_attention import decode_attention
from . import mesh as mesh_lib

Params = Any


# ------------------------------------------------------------ local linears

def _local_linear(x: torch.Tensor, p, *, apply_bias: bool = True) -> torch.Tensor:
    """One shard's projection -> f32 (JAX :57): a {'kernel', 'bias'?} dict
    or an INT8 QuantWeight shard. apply_bias=False for row-parallel shards,
    whose bias is added once after the ring. A QuantWeight is
    ``quant.quant_matmul`` (K2 on the card, bf16 out with the bias in its
    epilogue; its plain version elsewhere), as the single-device
    ``quant_linear``; a dense shard multiplies in its weights' dtype."""
    if isinstance(p, quant.QuantWeight):
        return quant.quant_matmul(x, p, p.bias if apply_bias else None).float()
    w, b = p["kernel"], p.get("bias")
    y = (x.to(w.dtype) @ w).float()
    if apply_bias and b is not None:
        y = y + b.float()
    return y


def _bias_of(p) -> Optional[torch.Tensor]:
    return p.bias if isinstance(p, quant.QuantWeight) else p.get("bias")


# ------------------------------------------------------------ ring psum

def ring_psum(x: torch.Tensor, ring: mesh_lib.Ring,
              overlap: Optional[Callable[[], Any]] = None):
    """All-reduce ``x`` over ``ring`` as tp - 1 hops (JAX :84): each rank
    sends its running buffer to the next and adds what it receives,
    ``acc = acc + buf`` in x's dtype (f32 partials). ``overlap``: a thunk
    run after the first hop is posted, before it is waited for, so its
    device work overlaps the transfer. -> (reduced, overlap's result).

    A ring moves (tp - 1) |x| bytes a rank against an all-reduce's
    2 (tp - 1) / tp |x|, but decode's collectives are a few KB and bound by
    latency, and tp - 1 separate hops give the work between them tp - 1
    places to hide a transfer."""
    if ring.size == 1:
        return x, (overlap() if overlap is not None else None)
    acc, buf, ov = x, x, None
    for i in range(ring.size - 1):
        ex = mesh_lib.start_exchange([buf], ring)
        if i == 0 and overlap is not None:
            ov = overlap()
        buf = mesh_lib.finish_exchange(ex)[0]
        acc = acc + buf
    return acc, ov


# ------------------------------------------------------------ param permute

def _strip_out_pad(qw: quant.QuantWeight) -> quant.QuantWeight:
    """Drop quantize_weight's 128-multiple out-axis zero padding (JAX
    :109): the TP body maps contiguous out columns to head and sense
    groups, and padded columns would land whole on the last shard. Only
    per-channel INT8 weights shard so: INT4 and grouped scales raise."""
    if qw.bits != 8 or qw.scale.shape[-2] != 1:
        raise ValueError("tp_decode takes per-channel INT8 trees; INT4 and grouped "
                         "trees take the replicated-compute path "
                         "(parallel/serving.py, tp_params=True)")
    if qw.q.shape[-1] == qw.d_out:
        return qw
    return dataclasses.replace(qw, q=qw.q[..., :qw.d_out],
                               scale=qw.scale[..., :qw.d_out])


def _perm_out(x: torch.Tensor, packs: int, n_grp: int, grp_d: int) -> torch.Tensor:
    """The LAST axis from (packs, n_grp, grp_d)-major to (n_grp, packs,
    grp_d)-major."""
    y = x.reshape(*x.shape[:-1], packs, n_grp, grp_d)
    return y.transpose(-3, -2).reshape(x.shape)


def _perm_lin(p, packs: int, n_grp: int, grp_d: int):
    if isinstance(p, quant.QuantWeight):
        p = _strip_out_pad(p)
        return dataclasses.replace(
            p, q=_perm_out(p.q, packs, n_grp, grp_d),
            scale=_perm_out(p.scale, packs, n_grp, grp_d),
            bias=(_perm_out(p.bias, packs, n_grp, grp_d)
                  if p.bias is not None else None))
    return {"kernel": _perm_out(p["kernel"], packs, n_grp, grp_d),
            "bias": _perm_out(p["bias"], packs, n_grp, grp_d)}


def permute_for_tp_decode(params: Params, cfg: BackpackConfig) -> Params:
    """Reorder the packed projection kernels so that a contiguous 'model'
    chunk is a group of whole heads or senses (JAX :119).

    Wqkv packs its out dim (3, h, dh)-major: a plain column chunk would
    split q, k and v, not heads; permuted to (h, 3, dh) a chunk is h / tp
    whole heads. The contextualization Wqkv's (2, nv, dnv) packing goes to
    (nv, 2, dnv). A lossless relayout, valid only for this module's steps.

    INT8 QuantWeight trees permute q, the per-out-channel scales and the
    bias alike, after dropping the out-axis pad; the explicit 'lm_head' is
    dropped: the step computes vocab-sharded logits from the INT8 wte
    shard, whose per-row scales are the lm_head quantization's (both
    absmax over d / 127). INT4 and grouped-scale trees raise."""
    h, dh = cfg.n_head, cfg.head_dim
    nv, dnv = cfg.num_senses, cfg.sense_head_dim
    out = dict(params)
    out["gpt"] = dict(out["gpt"])
    gl = dict(out["gpt"]["layers"])
    gl["Wqkv"] = _perm_lin(gl["Wqkv"], 3, h, dh)
    if isinstance(gl.get("out_proj"), quant.QuantWeight):
        gl["out_proj"] = _strip_out_pad(gl["out_proj"])
        gl["mlp"] = {"fc1": _strip_out_pad(gl["mlp"]["fc1"]),
                     "fc2": _strip_out_pad(gl["mlp"]["fc2"])}
    out["gpt"]["layers"] = gl
    out["gpt"].pop("lm_head", None)
    out["ctx_attn"] = {"Wqkv": _perm_lin(out["ctx_attn"]["Wqkv"], 2, nv, dnv)}
    return out


def tp_decode_param_specs(params: Params) -> Params:
    """The spec tree of :func:`permute_for_tp_decode`'s output (JAX :173).
    Everything not listed (the norms, wpe, the sense network's MLP) is
    replicated: at s = 1 the sense network is a few small products, and
    computing them on every rank beats a collective. The precomputed sense
    TABLE of a quantized tree shards over senses: it is the largest
    inference tensor (V x nv x d) and the tail reads only local senses."""
    specs = mesh_lib.replicated(params)

    def lin(p, kernel_spec, bias_spec, scale_spec):
        if isinstance(p, quant.QuantWeight):
            return dataclasses.replace(
                mesh_lib.replicated(p), q=kernel_spec, scale=scale_spec,
                bias=bias_spec if p.bias is not None else None)
        out = {"kernel": kernel_spec}
        if "bias" in p:
            out["bias"] = bias_spec
        return out

    gl_p, gl_s = params["gpt"]["layers"], specs["gpt"]["layers"]
    col3 = dict(kernel_spec=(None, None, "model"), bias_spec=(None, "model"),
                scale_spec=(None, None, "model"))
    row3 = dict(kernel_spec=(None, "model", None), bias_spec=(), scale_spec=())
    gl_s["Wqkv"] = lin(gl_p["Wqkv"], **col3)
    gl_s["out_proj"] = lin(gl_p["out_proj"], **row3)
    gl_s["mlp"]["fc1"] = lin(gl_p["mlp"]["fc1"], **col3)
    gl_s["mlp"]["fc2"] = lin(gl_p["mlp"]["fc2"], **row3)
    specs["ctx_attn"] = {"Wqkv": lin(params["ctx_attn"]["Wqkv"],
                                     kernel_spec=(None, "model"),
                                     bias_spec=("model",),
                                     scale_spec=(None, "model"))}
    if isinstance(params["gpt"]["wte"], dict):    # INT8 {'q', 'row_scale'}
        specs["gpt"]["wte"] = {"q": ("model", None), "row_scale": ("model", None)}
    else:
        specs["gpt"]["wte"] = ("model", None)
    table = params["content"].get("table") if "content" in params else None
    if table is not None:
        specs["content"]["table"] = dataclasses.replace(
            mesh_lib.replicated(table), q=(None, "model", None),
            scale=(None, "model", None))
    return specs


# ------------------------------------------------------------ TP cache

@dataclasses.dataclass
class TPDecodeCache:
    """Head- and sense-split decode cache (JAX :222):

      k:        (L, B, h, dk, S)   transposed keys
      v:        (L, B, h, S, dk)
      ctx_k:    (B, nv, dnv_pad, S)
      content:  (B, nv, S, d)
      *_scale:  f32 dequant scales (int8 caches only)
      length:   a Python int, or (B,) per-slot lengths

    A rank's cache (``prepare``) holds its slots and its heads and senses;
    the step writes it in place."""
    k: torch.Tensor
    v: torch.Tensor
    ctx_k: torch.Tensor
    content: torch.Tensor
    length: Union[int, torch.Tensor]
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    ctx_k_scale: Optional[torch.Tensor] = None
    content_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.content.dtype == torch.int8


def _reshape(x: Optional[torch.Tensor], *shape) -> Optional[torch.Tensor]:
    return None if x is None else x.reshape(*shape)


def to_tp_cache(cache: bp.BackpackCache, cfg: BackpackConfig) -> TPDecodeCache:
    """Split the single-device cache's flat E axes into (batch, heads)
    (JAX :245): views of its tensors. The staged and the low-bit caches
    raise."""
    if cache.staged or cache.bits == 4 or cache.gpt.bits == 4:
        raise ValueError("tp_decode takes unstaged bf16/f32 or INT8 caches "
                         "(flush a staged cache first)")
    L, E, dk, S = cache.gpt.k.shape
    h, nv = cfg.n_head, cfg.num_senses
    b = E // h
    return TPDecodeCache(
        k=cache.gpt.k.reshape(L, b, h, dk, S),
        v=cache.gpt.v.reshape(L, b, h, S, dk),
        k_scale=_reshape(cache.gpt.k_scale, L, b, h, S),
        v_scale=_reshape(cache.gpt.v_scale, L, b, h, S),
        ctx_k=cache.ctx_k.reshape(b, nv, -1, S),
        ctx_k_scale=_reshape(cache.ctx_k_scale, b, nv, S),
        content=cache.content.reshape(b, nv, S, cfg.n_embd),
        content_scale=_reshape(cache.content_scale, b, nv, S),
        length=cache.length)


def from_tp_cache(cache: TPDecodeCache, cfg: BackpackConfig) -> bp.BackpackCache:
    """The inverse of :func:`to_tp_cache` (JAX :266)."""
    L, b, h, dk, S = cache.k.shape
    nv = cfg.num_senses
    gpt_cache = gpt_lib.KVCache(
        k=cache.k.reshape(L, b * h, dk, S), v=cache.v.reshape(L, b * h, S, dk),
        length=cache.length, k_scale=_reshape(cache.k_scale, L, b * h, S),
        v_scale=_reshape(cache.v_scale, L, b * h, S))
    return bp.BackpackCache(
        gpt=gpt_cache, ctx_k=cache.ctx_k.reshape(b * nv, -1, S),
        ctx_k_scale=_reshape(cache.ctx_k_scale, b * nv, S),
        content=cache.content.reshape(b * nv, S, cfg.n_embd),
        content_scale=_reshape(cache.content_scale, b * nv, S),
        length=cache.length)


def tp_cache_specs(cache: TPDecodeCache) -> TPDecodeCache:
    """Slots over 'data', heads and senses over 'model' (JAX :288)."""
    def opt(spec, x):
        return spec if x is not None else None
    vec = isinstance(cache.length, torch.Tensor) and cache.length.dim() == 1
    return TPDecodeCache(
        k=(None, "data", "model", None, None),
        v=(None, "data", "model", None, None),
        k_scale=opt((None, "data", "model", None), cache.k_scale),
        v_scale=opt((None, "data", "model", None), cache.v_scale),
        ctx_k=("data", "model", None, None),
        ctx_k_scale=opt(("data", "model", None), cache.ctx_k_scale),
        content=("data", "model", None, None),
        content_scale=opt(("data", "model", None), cache.content_scale),
        length=("data",) if vec else ())


# ------------------------------------------------------------ the step

def _quant_store(buf: torch.Tensor, new: torch.Tensor, li: int, r0: int,
                 offset, vec: bool, *, col_axis: int) -> None:
    """Write ``new`` (the microbatch's rows, (nb * g, ...)) into the layer
    buffer (L, B, g, ...) at column ``offset`` of axis ``col_axis``
    (counted on the buffer), in place (JAX :313): a scalar offset by one
    slice, per-row offsets by ``models/gpt.update_rows_axis`` on the
    layer's rows."""
    g = buf.shape[2]
    nb = new.shape[0] // g
    block = buf[li, r0:r0 + nb]                      # (nb, g, ...) view
    if not vec:
        idx = [slice(None)] * block.dim()
        idx[col_axis - 1] = slice(offset, offset + new.shape[col_axis - 2])
        block[tuple(idx)] = new.reshape(block[tuple(idx)].shape).to(buf.dtype)
        return
    flat = block.reshape((nb * g,) + block.shape[2:])
    gpt_lib.update_rows_axis(flat, new, offset.repeat_interleave(g), col_axis - 2)


def _bp_store(buf: torch.Tensor, new: torch.Tensor, r0: int, offset,
              vec: bool, *, col_axis: int) -> None:
    """:func:`_quant_store` for the Backpack buffers (B, nv, ...) (JAX
    :336)."""
    g = buf.shape[1]
    nb = new.shape[0] // g
    block = buf[r0:r0 + nb]
    if not vec:
        idx = [slice(None)] * block.dim()
        idx[col_axis] = slice(offset, offset + new.shape[col_axis - 1])
        block[tuple(idx)] = new.reshape(block[tuple(idx)].shape).to(buf.dtype)
        return
    flat = block.reshape((nb * g,) + block.shape[2:])
    gpt_lib.update_rows_axis(flat, new, offset.repeat_interleave(g), col_axis - 1)


def _check_config(cfg: BackpackConfig, tp: int, microbatches: int) -> None:
    h, nv = cfg.n_head, cfg.num_senses
    if h % tp or nv % tp:
        raise ValueError(f"n_head {h} and num_senses {nv} must divide over the "
                         f"{tp} ranks of 'model'")
    if cfg.padded_vocab_size % tp:
        raise ValueError(f"the padded vocabulary {cfg.padded_vocab_size} must "
                         f"divide over the {tp} ranks of 'model'")
    if cfg.attn_dwconv:
        raise ValueError("cached decode does not support attn_dwconv")
    if microbatches not in (1, 2):
        raise ValueError(f"microbatches is 1 or 2, got {microbatches}")


def _build_body(cfg: BackpackConfig, mesh, *, window: Optional[int] = None,
                microbatches: int = 2):
    """This rank's decode step (JAX :356): the staggered layer schedule over
    its slots, heads and senses. Shared by make_tp_decode_step and
    make_tp_decode_scan."""
    ring = mesh_lib.ring_of(mesh, "model")
    t, tp = ring.rank, ring.size
    _check_config(cfg, tp, microbatches)
    h, nv, d = cfg.n_head, cfg.num_senses, cfg.n_embd
    h_loc, nv_loc = h // tp, nv // tp
    dk = cfg.head_dim
    dnv, dnv_pad = cfg.sense_head_dim, cfg.sense_head_dim_padded
    scales = gpt_lib._softmax_scales(cfg)
    model_group = mesh.get_group("model")

    def body(params: Params, tokens: torch.Tensor, cache: TPDecodeCache):
        bl = tokens.shape[0]
        offset = cache.length
        vec = isinstance(offset, torch.Tensor)
        new_len = offset + 1
        quantized = cache.quantized
        S = cache.k.shape[-1]
        W = min(window, S) if window is not None else S
        if not vec and new_len > W:
            raise ValueError(f"cache overflow: length {offset} + 1 exceeds max "
                             f"{S} / window {window}")
        n_mb = microbatches if bl >= microbatches else 1
        mb_rows = [bl // n_mb + (1 if i < bl % n_mb else 0) for i in range(n_mb)]
        mb_r0 = [sum(mb_rows[:i]) for i in range(n_mb)]

        def off_mb(i):
            return offset[mb_r0[i]:mb_r0[i] + mb_rows[i]] if vec else offset

        def lens_of(i, g):
            return (off_mb(i) + 1).repeat_interleave(g) if vec else new_len

        # ---- embedding: the vocab-sharded gather and one ring; INT8 wte
        # shards dequantize their local rows
        gp = params["gpt"]
        act = gpt_lib.quant_act_dtype(gp)
        wte_loc = gp["wte"]
        v_loc = (wte_loc["q"] if isinstance(wte_loc, dict) else wte_loc).shape[0]
        ids_loc = tokens.long() - t * v_loc
        ok = (ids_loc >= 0) & (ids_loc < v_loc)
        rows = gpt_lib.take_embedding(wte_loc, ids_loc.clamp(0, v_loc - 1), act)
        emb, _ = ring_psum(torch.where(ok[..., None], rows, 0), ring)

        # the sense network: a sense-sharded table gives this rank's nv_loc
        # senses; otherwise the MLP runs on every rank on the summed rows
        senses = bp.content_forward(params, cfg, tokens.long(), embedded=emb)
        senses_local = senses.shape[2] != nv

        if cfg.n_positions > 0:
            pos = (offset.long()[:, None] if vec
                   else torch.full((bl, 1), offset, device=tokens.device))
            pos = pos.clamp(max=cfg.n_positions - 1)
            emb = emb + gp["wpe"][pos].to(emb.dtype)
        hidden, residual = norms.dropout_add_layer_norm(
            emb, None, gp["ln_0"]["weight"], gp["ln_0"]["bias"], 0.0,
            cfg.layer_norm_epsilon)

        def attn_phase(i, hid, lp, scale, li):
            nb, r0 = mb_rows[i], mb_r0[i]
            e_mb = nb * h_loc
            qkv = _local_linear(hid, lp["Wqkv"]).to(hid.dtype)
            qkv = qkv.reshape(nb, 1, h_loc, 3, dk)
            q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
            rot = gpt_lib._rotary_tables(cfg, 1, off_mb(i), tokens.device)
            if rot is not None:
                q, k = rotary.rotate_qk(q, k, rot)
            kt_new = k.permute(0, 2, 3, 1).reshape(e_mb, dk, 1)
            v_new = v.permute(0, 2, 1, 3).reshape(e_mb, 1, dk)
            if quantized:
                k8, ks = quant.quantize_activations_int8(kt_new, axis=1)
                v8, vs = quant.quantize_activations_int8(v_new, axis=2)
                _quant_store(cache.k, k8, li, r0, off_mb(i), vec, col_axis=4)
                _quant_store(cache.v, v8, li, r0, off_mb(i), vec, col_axis=3)
                _quant_store(cache.k_scale, ks[:, 0, :], li, r0, off_mb(i), vec,
                             col_axis=3)
                _quant_store(cache.v_scale, vs[..., 0], li, r0, off_mb(i), vec,
                             col_axis=3)
            else:
                _quant_store(cache.k, kt_new, li, r0, off_mb(i), vec, col_axis=4)
                _quant_store(cache.v, v_new, li, r0, off_mb(i), vec, col_axis=3)
            # the window folded into the one layer slice: strided views of
            # the stacked buffers, no copy
            kt_c = cache.k[li, r0:r0 + nb, :, :, :W].reshape(e_mb, dk, W)
            v_c = cache.v[li, r0:r0 + nb, :, :W].reshape(e_mb, W, dk)
            k_sc = v_sc = None
            if quantized:
                k_sc = cache.k_scale[li, r0:r0 + nb, :, :W].reshape(e_mb, W)
                v_sc = cache.v_scale[li, r0:r0 + nb, :, :W].reshape(e_mb, W)
            qd = kt_c.dtype if kt_c.is_floating_point() else q.dtype
            qf = (q[:, 0].float() * scale).to(qd).reshape(e_mb, dk)
            ctx = decode_attention(qf, kt_c, k_sc, v_c, v_sc, lens_of(i, h_loc))
            ctx = ctx.to(q.dtype).reshape(nb, 1, h_loc * dk)
            return _local_linear(ctx, lp["out_proj"], apply_bias=False)

        def mlp_phase(hid, lp):
            y = _local_linear(hid, lp["mlp"]["fc1"]).to(hid.dtype)
            y = dense.ACTIVATIONS[cfg.activation](y)
            return _local_linear(y, lp["mlp"]["fc2"], apply_bias=False)

        def add_norm(part, bias, res, lp, which):
            x = (part + bias.float() if bias is not None else part).to(hidden.dtype)
            return norms.dropout_add_layer_norm(
                x, res, lp[which]["weight"], lp[which]["bias"], 0.0,
                cfg.layer_norm_epsilon)

        # ---- GPT stack: the staggered two-microbatch schedule
        hs = [hidden[r0:r0 + nb] for r0, nb in zip(mb_r0, mb_rows)]
        rs = [residual[r0:r0 + nb] for r0, nb in zip(mb_r0, mb_rows)]
        for li in range(cfg.n_layer):
            lp = gpt_lib.tree_index(gp["layers"], li)
            scale = scales[li]
            ob, fb = _bias_of(lp["out_proj"]), _bias_of(lp["mlp"]["fc2"])
            if n_mb == 1:
                a0, _ = ring_psum(attn_phase(0, hs[0], lp, scale, li), ring)
                hs[0], rs[0] = add_norm(a0, ob, rs[0], lp, "norm1")
                f0, _ = ring_psum(mlp_phase(hs[0], lp), ring)
                hs[0], rs[0] = add_norm(f0, fb, rs[0], lp, "norm2")
                continue
            # each ring's transfer behind the other microbatch's compute
            # (3 of 4 rings overlapped)
            p0 = attn_phase(0, hs[0], lp, scale, li)
            a0, p1 = ring_psum(p0, ring,
                               overlap=lambda: attn_phase(1, hs[1], lp, scale, li))
            hs[0], rs[0] = add_norm(a0, ob, rs[0], lp, "norm1")
            a1, m0 = ring_psum(p1, ring, overlap=lambda: mlp_phase(hs[0], lp))
            hs[1], rs[1] = add_norm(a1, ob, rs[1], lp, "norm1")
            f0, m1 = ring_psum(m0, ring, overlap=lambda: mlp_phase(hs[1], lp))
            hs[0], rs[0] = add_norm(f0, fb, rs[0], lp, "norm2")
            f1, _ = ring_psum(m1, ring)
            hs[1], rs[1] = add_norm(f1, fb, rs[1], lp, "norm2")

        # ---- Backpack tail, the same stagger: the ctx q and k, the cache
        # writes and the alpha-row contraction (partial over local senses),
        # then a ring
        sscale = dnv ** -0.5
        s0 = 0 if senses_local else t * nv_loc

        def tail_phase(i, hid):
            nb, r0 = mb_rows[i], mb_r0[i]
            e_mb = nb * nv_loc
            qk = _local_linear(hid, params["ctx_attn"]["Wqkv"]).to(hid.dtype)
            qk = qk.reshape(nb, 1, nv_loc, 2, dnv)
            q, k = qk[..., 0, :], qk[..., 1, :]
            k_flat = k.permute(0, 2, 3, 1).reshape(e_mb, dnv, 1)
            if dnv_pad != dnv:
                k_flat = torch.nn.functional.pad(k_flat, (0, 0, 0, dnv_pad - dnv))
            sl = senses[r0:r0 + nb, :, s0:s0 + nv_loc]
            s_t = sl.transpose(1, 2).reshape(e_mb, 1, d)
            off = off_mb(i)
            if quantized:
                k8, ksc = quant.quantize_activations_int8(k_flat, axis=1)
                s8, ssc = quant.quantize_activations_int8(s_t, axis=2)
                _bp_store(cache.ctx_k, k8, r0, off, vec, col_axis=3)
                _bp_store(cache.ctx_k_scale, ksc[:, 0, :], r0, off, vec, col_axis=2)
                _bp_store(cache.content, s8, r0, off, vec, col_axis=2)
                _bp_store(cache.content_scale, ssc[..., 0], r0, off, vec, col_axis=2)
            else:
                _bp_store(cache.ctx_k, k_flat, r0, off, vec, col_axis=3)
                _bp_store(cache.content, s_t, r0, off, vec, col_axis=2)
            kt_c = cache.ctx_k[r0:r0 + nb, :, :, :W].reshape(e_mb, dnv_pad, W)
            c_c = cache.content[r0:r0 + nb, :, :W].reshape(e_mb, W, d)
            k_sc = v_sc = None
            if quantized:
                k_sc = cache.ctx_k_scale[r0:r0 + nb, :, :W].reshape(e_mb, W)
                v_sc = cache.content_scale[r0:r0 + nb, :, :W].reshape(e_mb, W)
            qd = kt_c.dtype if kt_c.is_floating_point() else q.dtype
            qf = (q[:, 0].float() * sscale).to(qd).reshape(e_mb, dnv)
            if dnv_pad != dnv:
                qf = torch.nn.functional.pad(qf, (0, dnv_pad - dnv))
            out = decode_attention(qf, kt_c, k_sc, c_c, v_sc, lens_of(i, nv_loc))
            return out.reshape(nb, nv_loc, d).float().sum(dim=1, keepdim=True)

        def lm_local(out_full):
            """Vocab-sharded tied-head logits (JAX :600): from the INT8 wte
            shard, (out @ q^T) * row_scale, the single-device quantized
            lm_head's product (prepare keeps it as the QuantWeight
            ``gpt['head']``); else out @ wte_shard^T."""
            if "head" in gp:
                return _local_linear(out_full.to(act), gp["head"])
            return _local_linear(out_full.to(hidden.dtype), {"kernel": wte_loc.t()})

        if n_mb == 1:
            o0, _ = ring_psum(tail_phase(0, hs[0]), ring)
            logits_loc = lm_local(o0)
        else:
            o0 = tail_phase(0, hs[0])
            O0, o1 = ring_psum(o0, ring, overlap=lambda: tail_phase(1, hs[1]))
            O1, l0 = ring_psum(o1, ring, overlap=lambda: lm_local(O0))
            logits_loc = torch.cat([l0, lm_local(O1)], dim=0)
        logits = (torch.cat(mesh_lib.all_gather(logits_loc, model_group), dim=-1)
                  if tp > 1 else logits_loc)
        cache.length = new_len
        return logits, cache

    return body


def _pad_cols(x: torch.Tensor, n: int, value: float) -> torch.Tensor:
    pad = -x.shape[-1] % n
    return torch.nn.functional.pad(x, (0, pad), value=value) if pad else x


def _k2_ready(tree):
    """Each QuantWeight of a rank's tree as a weight of its own: d_out its
    local width (a column shard's), q and scale padded to K2's 128-column
    multiple (zeros and ones), contiguous."""
    if isinstance(tree, dict):
        return {k: _k2_ready(v) for k, v in tree.items()}
    if isinstance(tree, quant.QuantWeight):
        return dataclasses.replace(
            tree, d_out=min(tree.d_out, tree.q.shape[-1]),
            q=_pad_cols(tree.q, 128, 0).contiguous(),
            scale=_pad_cols(tree.scale, 128, 1.0).contiguous())
    return tree


def make_tp_decode_step(cfg: BackpackConfig, mesh, *, window: Optional[int] = None,
                        microbatches: int = 2):
    """The overlapped TP decode step over ``mesh`` ('data', 'model') (JAX
    :640). Returns (step, prepare):

      step(params, tokens, cache) -> (logits (b_loc, 1, V) f32, cache):
        this rank's rows (tokens (b_loc, 1) of its data shard), the
        vocabulary all-gathered over 'model'; the cache updated in place;
        params and cache from ``prepare``.
      prepare(params, cache) -> (tp_params, tp_cache): the whole tree and
        cache on every rank (a flat BackpackCache or a TPDecodeCache) ->
        this rank's shards: the kernels permuted
        (:func:`permute_for_tp_decode`), sliced by
        :func:`tp_decode_param_specs` and :func:`tp_cache_specs`, each INT8
        shard padded to K2's 128-column multiple, and the tied head of an
        INT8 wte shard as a QuantWeight ``gpt['head']``.

    n_head, num_senses and the padded vocabulary must divide over 'model'.
    Takes bf16/f32 trees or INT8 QuantWeight trees
    (``models/quantized.quantize_backpack_params``: INT8 weights, the INT8
    sense table, with INT8 caches the flagship configuration); INT4 trees
    take ``parallel/serving.py`` with ``tp_params=True``. window: a static
    length bucket, as in ``backpack_forward_with_cache``."""
    body = _build_body(cfg, mesh, window=window, microbatches=microbatches)

    @torch.no_grad()
    def step(params, tokens, cache):
        return body(params, tokens, cache)

    def prepare(params, cache):
        tp_params = permute_for_tp_decode(params, cfg)
        local = _k2_ready(mesh_lib.shard_tree(tp_params, tp_decode_param_specs(tp_params),
                                              mesh))
        wte = local["gpt"]["wte"]
        if isinstance(wte, dict):
            # the tied head from the INT8 wte shard: (d, V_loc) codes, the rows'
            # scales per output column
            local["gpt"]["head"] = _k2_ready(quant.QuantWeight(
                q=wte["q"].t(), scale=wte["row_scale"].t(), bias=None, bits=8,
                d_out=wte["q"].shape[0]))
        if isinstance(cache, bp.BackpackCache):
            cache = to_tp_cache(cache, cfg)
        return local, mesh_lib.shard_tree(cache, tp_cache_specs(cache), mesh)

    return step, prepare


def make_tp_decode_scan(cfg: BackpackConfig, mesh, *, steps: int,
                        window: Optional[int] = None, microbatches: int = 2,
                        donate: bool = True):
    """Greedy decode of ``steps`` tokens with the step body (JAX :686):
    scan(params, tokens, cache) -> (tokens (b_loc, 1), cache), inputs from
    make_tp_decode_step's ``prepare``. Every rank of a 'model' ring picks
    the same token (its logits are the all-gathered whole). The cache is
    updated in place; ``donate=False`` steps a copy and leaves the
    caller's as it was."""
    body = _build_body(cfg, mesh, window=window, microbatches=microbatches)

    @torch.no_grad()
    def scan(params, tokens, cache):
        if not donate:
            cache = mesh_lib.map_with_specs(lambda x, _: x.clone(), cache,
                                            tp_cache_specs(cache))
        tok = tokens
        for _ in range(steps):
            logits, cache = body(params, tok, cache)
            tok = logits[:, -1].argmax(-1)[:, None].to(tokens.dtype)
        return tok, cache

    return scan
