"""Param-tree quantization: fp trees -> INT8 weight-only inference trees.

Port of ``backpacks_flash_attn_tpu/models/quantized.py`` (:26-158): weight-
only quantization of every dense layer, INT8 row-quantized embeddings, a
quantized precomputed (vocab, nv, d) sense table with per-token-per-sense
scales, and an explicit quantized (d, V) lm_head. The quantized trees run
through the same model functions, dispatched by ``ops/dense.linear``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..config import BackpackConfig, GPTConfig
from ..ops import quant
from . import backpack as bp

Params = Dict[str, Any]


def quantize_embedding_rows(wte: torch.Tensor) -> dict:
    """Per-row INT8 embedding table: {'q': (V, d) int8, 'row_scale': (V, 1)}."""
    q, scale = quant.quantize_activations_int8(wte, axis=-1)
    return {"q": q, "row_scale": scale.float()}


def _quantize_linear_tree(tree, bits: int):
    """Replace every {'kernel', 'bias'?} leaf (stacked (n_layer, in, out)
    kernels included) with a per-channel QuantWeight."""
    if isinstance(tree, dict) and "kernel" in tree:
        return quant.quantize_linear_params(tree, bits)
    if isinstance(tree, dict):
        return {k: _quantize_linear_tree(v, bits) for k, v in tree.items()}
    return tree


def _f32(tree):
    return {k: v.float() for k, v in tree.items()}


def quantize_gpt_params(params: Params, cfg: GPTConfig, *, bits: int = 8,
                        act_dtype=torch.bfloat16) -> Params:
    """Quantize a GPT tree. Layer norms stay f32; embeddings go INT8
    per-row; lm_head becomes an explicit quantized (d, V) kernel of
    max(bits, 8) bits; wpe is cast to act_dtype, the dtype the quantized
    path then computes in."""
    if "moe" in params["layers"]:
        raise NotImplementedError("MoE layers are not ported yet")
    out: Params = {
        "wte": quantize_embedding_rows(params["wte"]),
        "ln_0": _f32(params["ln_0"]),
        "layers": _quantize_linear_tree(
            {k: v for k, v in params["layers"].items()
             if k in ("Wqkv", "out_proj", "mlp")}, bits),
        "lm_head": quant.quantize_weight(params["wte"].T.float(), max(bits, 8)),
    }
    for norm in ("norm1", "norm2"):
        out["layers"][norm] = _f32(params["layers"][norm])
    if "wpe" in params:
        out["wpe"] = params["wpe"].to(act_dtype)
    return out


def quantize_backpack_params(params: Params, cfg: BackpackConfig, *,
                             bits: int = 8,
                             act_dtype=torch.bfloat16) -> Params:
    """Quantize a Backpack tree for inference: the sense network becomes a
    gather from the precomputed, quantized sense table."""
    blocks = params["content"]["blocks"]
    out: Params = {
        "gpt": quantize_gpt_params(params["gpt"], cfg, bits=bits,
                                   act_dtype=act_dtype),
        "ctx_attn": _quantize_linear_tree(params["ctx_attn"], bits),
        "content": {
            "ln_0": _f32(params["content"]["ln_0"]),
            "blocks": _quantize_linear_tree({"mlp": blocks["mlp"]}, bits)
            | {norm: _f32(blocks[norm]) for norm in ("norm1", "norm2")},
            "final_mlp": _quantize_linear_tree(params["content"]["final_mlp"],
                                               bits),
        },
    }
    table = bp.sense_table(params, cfg)                # fp (V, nv, d)
    out["content"]["table"] = quantize_sense_table(table, bits)
    return out


def quantize_sense_table(table: torch.Tensor, bits: int = 8,
                         group_size: Optional[int] = None) -> quant.QuantTable:
    """(V, nv, d) -> QuantTable(q int8 (V, nv, d[/2]), scale (V, nv, d/g)).
    Per-token-per-sense scales by default; INT4 defaults to group_size 64."""
    if group_size is None and bits == 4:
        group_size = 64
    qmax = 127.0 if bits == 8 else 7.0
    tf = table.float()
    V, nv, d = tf.shape
    if group_size:
        if d % group_size or group_size % 2:
            raise ValueError(f"group_size {group_size} does not fit d={d}")
        g = tf.reshape(V, nv, d // group_size, group_size)
        scale = torch.clamp_min(g.abs().amax(dim=-1) / qmax, 1e-10)
        q = torch.clamp(torch.round(g / scale[..., None]), -qmax, qmax
                        ).to(torch.int8).reshape(V, nv, d)
    else:
        scale = torch.clamp_min(tf.abs().amax(dim=-1, keepdim=True) / qmax,
                                1e-10)
        q = torch.clamp(torch.round(tf / scale), -qmax, qmax).to(torch.int8)
    if bits == 4:
        q = quant.pack_int4_last(q)
    return quant.QuantTable(q=q, scale=scale, bits=bits)
