"""Typed model configurations (PyTorch port).

A copy of ``backpacks_flash_attn_tpu/config.py`` with torch dtypes: the port
imports nothing from the JAX package, whose ``config.py`` pulls in
``jax.numpy``. Field names, defaults and presets are identical, so a config
built here describes the same model as its JAX twin.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class GPTConfig:
    """GPT-2 style decoder config."""

    vocab_size: int = 50257
    n_positions: int = 1024          # max learned positions; <=0 disables pos emb
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_inner: Optional[int] = None    # default 4*n_embd
    activation: str = "gelu_new"     # 'gelu_new'/'gelu_fast' => tanh approx; 'gelu' => exact
    layer_norm_epsilon: float = 1e-5
    embd_pdrop: float = 0.1
    resid_pdrop: float = 0.1
    attn_pdrop: float = 0.1
    initializer_range: float = 0.02
    scale_attn_by_inverse_layer_idx: bool = False
    pad_vocab_size_multiple: int = 1
    rotary_emb_fraction: float = 0.0
    rotary_emb_scale_base: int = 0
    attn_dwconv: bool = False
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def inner_dim(self) -> int:
        return self.n_inner if self.n_inner is not None else 4 * self.n_embd

    @property
    def rotary_emb_dim(self) -> int:
        return (int(self.rotary_emb_fraction * self.head_dim) // 2) * 2

    @property
    def padded_vocab_size(self) -> int:
        return _round_up(self.vocab_size, self.pad_vocab_size_multiple)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class BackpackConfig(GPTConfig):
    """Backpack LM config: GPTConfig + sense-vector count."""

    num_senses: int = 16
    content_n_layer: int = 1
    shrink_final_inner: bool = False

    @property
    def sense_head_dim(self) -> int:
        """Head dim of the contextualization attention (d / nv)."""
        return self.n_embd // self.num_senses

    @property
    def sense_head_dim_padded(self) -> int:
        """sense_head_dim zero-padded up to a 64 multiple: the decode-path
        ctx_k cache stores padded keys (48 -> 64 for backpack-small)."""
        return -(-self.sense_head_dim // 64) * 64


def backpack_nano(**kw) -> BackpackConfig:
    return BackpackConfig(n_embd=128, n_head=2, n_layer=2, num_senses=4,
                          n_positions=512,
                          scale_attn_by_inverse_layer_idx=True,
                          pad_vocab_size_multiple=8, **kw)


def backpack_micro(**kw) -> BackpackConfig:
    return BackpackConfig(n_embd=384, n_head=6, n_layer=6, n_positions=512,
                          scale_attn_by_inverse_layer_idx=True,
                          pad_vocab_size_multiple=8, **kw)


def backpack_mini(**kw) -> BackpackConfig:
    return BackpackConfig(n_embd=640, n_head=8, n_layer=8, n_positions=512,
                          scale_attn_by_inverse_layer_idx=True,
                          pad_vocab_size_multiple=8, **kw)


def backpack_small(**kw) -> BackpackConfig:
    return BackpackConfig(n_embd=768, n_head=12, n_layer=12, n_positions=512,
                          scale_attn_by_inverse_layer_idx=True,
                          pad_vocab_size_multiple=8, **kw)


def gpt2_small(**kw) -> GPTConfig:
    return GPTConfig(n_embd=768, n_head=12, n_layer=12, **kw)


def gpt2_medium(**kw) -> GPTConfig:
    return GPTConfig(n_embd=1024, n_head=16, n_layer=24, **kw)


def gpt2_large(**kw) -> GPTConfig:
    return GPTConfig(n_embd=1280, n_head=20, n_layer=36, **kw)


def gpt2_xlarge(**kw) -> GPTConfig:
    return GPTConfig(n_embd=1600, n_head=25, n_layer=48, **kw)


def _gpt3(embd, head, layer, *, seqlen=2048, rotary=False, **kw):
    kw.setdefault("pad_vocab_size_multiple", 8)
    if rotary:
        kw.setdefault("rotary_emb_fraction", 0.5)
        kw.setdefault("n_positions", 0)
    else:
        kw.setdefault("n_positions", seqlen)
    kw.setdefault("n_embd", embd)
    kw.setdefault("n_head", head)
    kw.setdefault("n_layer", layer)
    return GPTConfig(**kw)


def gpt3_small(**kw) -> GPTConfig:     # 125M
    return _gpt3(768, 12, 12, **kw)


def gpt3_medium(**kw) -> GPTConfig:    # 355M
    return _gpt3(1024, 16, 24, **kw)


def gpt3_large(**kw) -> GPTConfig:     # 760M
    return _gpt3(1536, 16, 24, **kw)


def gpt3_xl(**kw) -> GPTConfig:        # 1.3B
    return _gpt3(2048, 16, 24, **kw)


def gpt3_2_7b(**kw) -> GPTConfig:      # 2.7B
    return _gpt3(2560, 32, 32, **kw)


def backpack_test(**kw) -> BackpackConfig:
    kw.setdefault("vocab_size", 512)
    kw.setdefault("n_positions", 128)
    return BackpackConfig(n_embd=64, n_head=4, n_layer=2, num_senses=4,
                          scale_attn_by_inverse_layer_idx=True,
                          pad_vocab_size_multiple=8, **kw)


def gpt2_test(**kw) -> GPTConfig:
    kw.setdefault("vocab_size", 512)
    kw.setdefault("n_positions", 128)
    return GPTConfig(n_embd=64, n_head=4, n_layer=2, **kw)


DTYPE_MAP = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}
