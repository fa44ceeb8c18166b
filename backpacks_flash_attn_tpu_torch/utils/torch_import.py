"""Checkpoint import: reference (PyTorch/Lightning) state dicts -> the port's
parameter trees.

Port of ``backpacks_flash_attn_tpu/utils/torch_import.py``. The released
Backpack checkpoints are PyTorch-Lightning ``.ckpt`` pickles with the model
under a ``model.`` prefix (reference: training/src/eval.py:28-44); module
names follow the reference's optimized layout (transformer.layers.N.mixer.Wqkv
etc.). This module maps that layout into the port's trees, the layout
``utils/weights.params_from_numpy`` gives for the JAX package's import of
the same file:

  * torch nn.Linear stores (out, in); the port's kernels are (in, out):
    transposed.
  * per-layer tensors are stacked on a leading n_layer axis.
  * word embeddings are padded to cfg.padded_vocab_size and lm_head stays
    weight-tied.

Every leaf goes through float32 on the host (as the JAX package reads it)
and is cast to ``dtype`` on ``device``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..config import BackpackConfig, GPTConfig
from ..ops import _build

Params = Dict[str, Any]


def _to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x)


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load a torch pickle (.ckpt/.pt); returns a flat {key: np.ndarray} dict
    (floating leaves as float32). Lightning checkpoints ('state_dict' with
    'model.' prefixes) are unwrapped. ``weights_only=False`` as the JAX
    package loads them: a Lightning checkpoint pickles more than tensors
    (torch's default became True), so load only files you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    out = {}
    for k, v in obj.items():
        if k.startswith("model."):
            k = k[len("model."):]
        out[k] = _to_np(v)
    return out


class _Leaves:
    """Host float32 arrays -> tensors of one dtype on one device."""

    def __init__(self, dtype, device):
        self.dtype = dtype
        self.device = _build.resolve_device(device)

    def __call__(self, a) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(_to_np(a), np.float32))
        return t.to(device=self.device, dtype=self.dtype)

    def linear(self, sd, prefix: str) -> dict:
        p = {"kernel": self(_to_np(sd[prefix + ".weight"]).T)}
        if prefix + ".bias" in sd:
            p["bias"] = self(sd[prefix + ".bias"])
        return p

    def norm(self, sd, prefix: str) -> dict:
        return {"weight": self(sd[prefix + ".weight"]),
                "bias": self(sd[prefix + ".bias"])}

    def mlp(self, sd, prefix: str) -> dict:
        return {"fc1": self.linear(sd, prefix + ".fc1"),
                "fc2": self.linear(sd, prefix + ".fc2")}


def _stack(dicts):
    if isinstance(dicts[0], dict):
        return {k: _stack([d[k] for d in dicts]) for k in dicts[0]}
    return torch.stack(dicts)


def _pad_vocab(wte: np.ndarray, cfg: GPTConfig) -> np.ndarray:
    v = cfg.padded_vocab_size
    if wte.shape[0] < v:
        wte = np.pad(wte, ((0, v - wte.shape[0]), (0, 0)))
    return wte[:v]


def gpt_params_from_state_dict(sd: Mapping[str, Any], cfg: GPTConfig,
                               prefix: str = "transformer.",
                               dtype=torch.float32, device="cuda") -> Params:
    """Import a reference GPTModel/GPTLMHeadModel state dict (layout per
    flash_attn/models/gpt.py:285-340 after remap; JAX :81)."""
    t = _Leaves(dtype, device)
    params: Params = {
        "wte": t(_pad_vocab(_to_np(
            sd[prefix + "embeddings.word_embeddings.weight"]), cfg)),
        "ln_0": t.norm(sd, prefix + "ln_0"),
    }
    if cfg.n_positions > 0:
        params["wpe"] = t(sd[prefix + "embeddings.position_embeddings.weight"])
    layers = []
    for i in range(cfg.n_layer):
        lp = f"{prefix}layers.{i}."
        layers.append({
            "Wqkv": t.linear(sd, lp + "mixer.Wqkv"),
            "out_proj": t.linear(sd, lp + "mixer.out_proj"),
            "norm1": t.norm(sd, lp + "norm1"),
            "mlp": t.mlp(sd, lp + "mlp"),
            "norm2": t.norm(sd, lp + "norm2"),
        })
    params["layers"] = _stack(layers)
    return params


def backpack_params_from_state_dict(sd: Mapping[str, Any],
                                    cfg: BackpackConfig,
                                    dtype=torch.float32,
                                    device="cuda") -> Params:
    """Import a reference BackpackLMHeadModel state dict (module layout per
    training/src/models/backpack.py:278-340; JAX :107)."""
    t = _Leaves(dtype, device)
    gpt = gpt_params_from_state_dict(sd, cfg, "transformer.gpt2_model.",
                                     dtype, t.device)
    cp = "transformer.content_model."
    blocks = []
    for i in range(cfg.content_n_layer):
        bp = f"{cp}layers.{i}."
        blocks.append({
            "norm1": t.norm(sd, bp + "norm1"),
            "mlp": t.mlp(sd, bp + "mlp"),
            "norm2": t.norm(sd, bp + "norm2"),
        })
    return {
        "gpt": gpt,
        "ctx_attn": {
            "Wqkv": t.linear(sd, "transformer.contextualization_attn.Wqkv")},
        "content": {
            "ln_0": t.norm(sd, cp + "ln_0"),
            "blocks": _stack(blocks),
            "final_mlp": t.mlp(sd, cp + "final_mlp"),
        },
    }


def load_backpack_checkpoint(path: str, cfg: BackpackConfig,
                             dtype=torch.float32, device="cuda") -> Params:
    return backpack_params_from_state_dict(load_torch_checkpoint(path), cfg,
                                           dtype, device)


def load_gpt_checkpoint(path: str, cfg: GPTConfig, dtype=torch.float32,
                        device="cuda") -> Params:
    return gpt_params_from_state_dict(load_torch_checkpoint(path), cfg,
                                      dtype=dtype, device=device)


# ---------------------------------------------------------------- HF GPT-2

def gpt_params_from_hf_gpt2(sd: Mapping[str, Any], cfg: GPTConfig,
                            dtype=torch.float32, device="cuda") -> Params:
    """Import a raw HuggingFace GPT-2 state dict (wte/wpe/h.N.* layout; JAX
    :162), including the shifted-LN mapping for the reordered prenorm
    residual (reference flash_attn/models/gpt.py:285-340). HF's Conv1D
    stores (in, out) already: no transpose."""
    t = _Leaves(dtype, device)

    def lin(name):
        return {"kernel": t(sd[name + ".weight"]), "bias": t(sd[name + ".bias"])}

    def norm(name):
        return {"weight": t(sd[name + ".weight"]), "bias": t(sd[name + ".bias"])}

    params: Params = {
        "wte": t(_pad_vocab(_to_np(sd["wte.weight"]), cfg)),
        "wpe": t(sd["wpe.weight"]),
        # first block's ln_1 becomes the model-level ln_0
        "ln_0": norm("h.0.ln_1"),
    }
    n = cfg.n_layer
    layers = []
    for i in range(n):
        # norm1_i <- ln_2 of block i; norm2_i <- ln_1 of block i+1 (ln_f last)
        layers.append({
            "Wqkv": lin(f"h.{i}.attn.c_attn"),
            "out_proj": lin(f"h.{i}.attn.c_proj"),
            "norm1": norm(f"h.{i}.ln_2"),
            "mlp": {"fc1": lin(f"h.{i}.mlp.c_fc"),
                    "fc2": lin(f"h.{i}.mlp.c_proj")},
            "norm2": norm(f"h.{i + 1}.ln_1" if i < n - 1 else "ln_f"),
        })
    params["layers"] = _stack(layers)
    return params


# ---------------------------------------------------------------- export

def state_dict_from_backpack_params(params: Params,
                                    cfg: BackpackConfig) -> Dict[str, np.ndarray]:
    """Inverse mapping (JAX :198): the port's tree -> a reference-layout
    state dict of float32 arrays, for round trips and for exporting back to
    the torch ecosystem."""
    sd: Dict[str, np.ndarray] = {}

    def put_linear(prefix, p):
        sd[prefix + ".weight"] = np.ascontiguousarray(_to_np(p["kernel"]).T)
        if "bias" in p:
            sd[prefix + ".bias"] = _to_np(p["bias"])

    def put_norm(prefix, p):
        sd[prefix + ".weight"] = _to_np(p["weight"])
        sd[prefix + ".bias"] = _to_np(p["bias"])

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return tree[i]

    g = params["gpt"]
    gp = "transformer.gpt2_model."
    sd[gp + "embeddings.word_embeddings.weight"] = _to_np(g["wte"])
    if "wpe" in g:
        sd[gp + "embeddings.position_embeddings.weight"] = _to_np(g["wpe"])
    put_norm(gp + "ln_0", g["ln_0"])
    for i in range(cfg.n_layer):
        lyr = layer(g["layers"], i)
        lp = f"{gp}layers.{i}."
        put_linear(lp + "mixer.Wqkv", lyr["Wqkv"])
        put_linear(lp + "mixer.out_proj", lyr["out_proj"])
        put_norm(lp + "norm1", lyr["norm1"])
        put_linear(lp + "mlp.fc1", lyr["mlp"]["fc1"])
        put_linear(lp + "mlp.fc2", lyr["mlp"]["fc2"])
        put_norm(lp + "norm2", lyr["norm2"])
    put_linear("transformer.contextualization_attn.Wqkv",
               params["ctx_attn"]["Wqkv"])
    cpfx = "transformer.content_model."
    put_norm(cpfx + "ln_0", params["content"]["ln_0"])
    for i in range(cfg.content_n_layer):
        blk = layer(params["content"]["blocks"], i)
        bp = f"{cpfx}layers.{i}."
        put_norm(bp + "norm1", blk["norm1"])
        put_linear(bp + "mlp.fc1", blk["mlp"]["fc1"])
        put_linear(bp + "mlp.fc2", blk["mlp"]["fc2"])
        put_norm(bp + "norm2", blk["norm2"])
    put_linear(cpfx + "final_mlp.fc1", params["content"]["final_mlp"]["fc1"])
    put_linear(cpfx + "final_mlp.fc2", params["content"]["final_mlp"]["fc2"])
    sd["lm_head.weight"] = sd[gp + "embeddings.word_embeddings.weight"]
    sd["transformer.embeddings.word_embeddings.weight"] = sd[
        gp + "embeddings.word_embeddings.weight"]
    return sd
