"""Vision Transformer (PyTorch port): patch embedding, pre-norm encoder,
CLS-token head.

Port of ``backpacks_flash_attn_tpu/models/vit.py``: pure functions over a
dict of tensors in the JAX tree layout. The patch embedding is the
reshape of :func:`patchify` and one GEMM (a conv whose stride is its
kernel), the blocks are pre-norm (h += f(LN(h))) with bidirectional
attention through the flash wrapper (K3 forward, K5 backward) at
1 + (image / patch)^2 tokens (197 for ViT-B/16 at 224, a multiple of no
tile), and the logits are the head over the final LN's CLS token. Where
JAX scans over layers, the port loops; every dropout key splits as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops import _build, dense, norms
from ..ops.attention import mha
from ..utils import prng
from ..utils.weights import leaf_to_numpy, params_from_numpy, stack_numpy
from .gpt import _stack, tree_index

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """The defaults are ViT-B/16 at 224 x 224 (12 x 768, 12 heads, 197
    tokens, 1000 classes)."""
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-6
    num_classes: int = 1000
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    initializer_range: float = 0.02

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def vit_test(**kw) -> ViTConfig:
    """JAX's test size: 16 x 16 images of 4 x 4 patches, 2 layers of 64."""
    return ViTConfig(image_size=16, patch_size=4, hidden_size=64,
                     num_hidden_layers=2, num_attention_heads=4,
                     intermediate_size=128, num_classes=10, **kw)


# ---------------------------------------------------------------- init

def init_vit(cfg: ViTConfig, generator: torch.Generator,
             dtype=torch.float32, device="cuda") -> Params:
    """N(0, initializer_range^2) weights (position embeddings N(0, 0.02^2)),
    zero biases and CLS token, unit norms (JAX's layout; the numbers
    differ from JAX's for the same seed)."""
    device = _build.resolve_device(device)
    d, std = cfg.hidden_size, cfg.initializer_range
    kw = dict(dtype=dtype, device=device)
    lin = lambda d_in, d_out: dense.init_linear(generator, d_in, d_out,
                                                std=std, **kw)
    pdim = cfg.num_channels * cfg.patch_size ** 2
    layers = [{
        "norm1": norms.init_layer_norm(d, **kw),
        "Wqkv": lin(d, 3 * d),
        "out_proj": lin(d, d),
        "norm2": norms.init_layer_norm(d, **kw),
        "mlp": {"fc1": lin(d, cfg.intermediate_size),
                "fc2": lin(cfg.intermediate_size, d)},
    } for _ in range(cfg.num_hidden_layers)]
    return {
        "patch_embed": lin(pdim, d),
        "cls_token": torch.zeros((1, 1, d), **kw),
        "pos_embed": dense._normal(generator, (1, cfg.num_patches + 1, d),
                                   0.02, dtype, device),
        "layers": _stack(layers),
        "norm": norms.init_layer_norm(d, **kw),
        "head": lin(d, cfg.num_classes),
    }


# ---------------------------------------------------------------- forward

def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(b, c, H, W) -> (b, n_patches, c * p * p), each patch flattened in
    (c, ph, pw) order, the layout of a conv kernel, so a conv's weights
    import as a reshape (JAX :101)."""
    b, c, H, W = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(b, c, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)           # (b, gh, gw, c, p, p)
    return x.reshape(b, gh * gw, c * patch * patch)


def vit_features(params: Params, cfg: ViTConfig, images: torch.Tensor, *,
                 train: bool = False,
                 rng: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-> (b, 1 + n_patches, d) token features after the final LN (JAX
    :114). train with a key ``rng`` of ``utils.prng`` turns on the
    attention dropout (in the flash kernels) and the two residual ones."""
    b = images.shape[0]
    d = cfg.hidden_size
    x = dense.linear(patchify(images, cfg.patch_size), params["patch_embed"])
    cls = params["cls_token"].to(x.dtype).expand(b, 1, d)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(x.dtype)
    rngs = prng.split(rng, cfg.num_hidden_layers) if rng is not None else None
    det = not train
    for li in range(cfg.num_hidden_layers):
        lp = tree_index(params["layers"], li)
        r_attn, r_d1, r_d2 = (prng.split(rngs[li], 3) if rngs is not None
                              else (None, None, None))
        h = norms.layer_norm(x, lp["norm1"]["weight"], lp["norm1"]["bias"],
                             cfg.layer_norm_eps)
        s = h.shape[1]
        qkv = dense.linear(h, lp["Wqkv"]).reshape(
            b, s, 3, cfg.num_attention_heads, cfg.head_dim)
        ctx = mha(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=False,
                  dropout_p=cfg.attn_drop_rate, dropout_rng=r_attn,
                  deterministic=det)
        attn_out = dense.linear(ctx.reshape(b, s, d), lp["out_proj"])
        x = x + norms.dropout(attn_out, cfg.drop_rate, r_d1, deterministic=det)
        h = norms.layer_norm(x, lp["norm2"]["weight"], lp["norm2"]["bias"],
                             cfg.layer_norm_eps)
        mlp_out = dense.linear(h, lp["mlp"]["fc1"])
        mlp_out = dense.gelu(mlp_out, approximate=cfg.hidden_act == "gelu_new")
        mlp_out = dense.linear(mlp_out, lp["mlp"]["fc2"])
        x = x + norms.dropout(mlp_out, cfg.drop_rate, r_d2, deterministic=det)
    return norms.layer_norm(x, params["norm"]["weight"], params["norm"]["bias"],
                            cfg.layer_norm_eps)


def vit_forward(params: Params, cfg: ViTConfig, images: torch.Tensor,
                **kw) -> torch.Tensor:
    """-> (b, num_classes) logits from the CLS token (JAX :163)."""
    feats = vit_features(params, cfg, images, **kw)
    return dense.linear(feats[:, 0], params["head"])


# ---------------------------------------------------------------- HF import

def remap_hf_vit(state_dict, cfg: ViTConfig, head_prefix: str = "classifier",
                 *, device="cuda", dtype=None) -> Params:
    """A HuggingFace ViTForImageClassification state dict (tensors or numpy
    arrays under HF's key names) in this layout (JAX :172): kernels
    transposed, q, k and v fused into Wqkv, the patch conv (d, c, p, p)
    flattened to a (c * p * p, d) kernel, layers stacked. -> a tensor tree
    on ``device`` (dtype: cast the floats)."""
    A = lambda key: leaf_to_numpy(state_dict[key])
    lin = lambda p: {"kernel": A(p + ".weight").T, "bias": A(p + ".bias")}
    ln = lambda p: {"weight": A(p + ".weight"), "bias": A(p + ".bias")}
    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"vit.encoder.layer.{i}"
        qkv = [f"{p}.attention.attention.{n}" for n in ("query", "key", "value")]
        layers.append({
            "norm1": ln(f"{p}.layernorm_before"),
            "Wqkv": {"kernel": np.concatenate([A(n + ".weight") for n in qkv], 0).T,
                     "bias": np.concatenate([A(n + ".bias") for n in qkv], 0)},
            "out_proj": lin(f"{p}.attention.output.dense"),
            "norm2": ln(f"{p}.layernorm_after"),
            "mlp": {"fc1": lin(f"{p}.intermediate.dense"),
                    "fc2": lin(f"{p}.output.dense")},
        })
    conv_w = A("vit.embeddings.patch_embeddings.projection.weight")
    tree = {
        "patch_embed": {"kernel": conv_w.reshape(conv_w.shape[0], -1).T,
                        "bias": A("vit.embeddings.patch_embeddings.projection.bias")},
        "cls_token": A("vit.embeddings.cls_token"),
        "pos_embed": A("vit.embeddings.position_embeddings"),
        "layers": stack_numpy(layers),
        "norm": ln("vit.layernorm"),
        "head": lin(head_prefix),
    }
    return params_from_numpy(tree, device, dtype)
