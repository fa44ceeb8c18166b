"""BERT (PyTorch port): the post-norm bidirectional encoder, MLM and NSP.

Port of ``backpacks_flash_attn_tpu/models/bert.py``: pure functions over a
dict of tensors in the JAX tree layout (kernels ``(in, out)``, layers
stacked on a leading axis), a padded batch whose raggedness is a key
padding mask (``mha`` turns it into per-sequence lengths for the ragged
flash entry, K3), attention dropout in the flash kernels in training (K3
forward, K5 backward), and ``dense_seq_output``'s MLM head over a static
gather of at most ``masked_budget`` masked positions a batch. Where JAX
scans over layers, the port loops; every dropout key splits as in JAX
(``utils.prng``), so the masks are JAX's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import _build, dense, norms
from ..ops.attention import mha
from ..ops.cross_entropy import cross_entropy_loss
from ..utils import prng
from ..utils.weights import leaf_to_numpy, params_from_numpy, stack_numpy
from .gpt import _stack, tree_index

Params = Dict[str, Any]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """The HF BertConfig knobs the model reads; the defaults are
    bert-base-uncased (12 x 768, 12 heads, vocab 30522)."""
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"          # 'gelu_new'/'gelu_fast' => tanh approx
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    pad_vocab_size_multiple: int = 1
    dense_seq_output: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def padded_vocab_size(self) -> int:
        return _round_up(self.vocab_size, self.pad_vocab_size_multiple)


def bert_test(**kw) -> BertConfig:
    """JAX's test size: 2 layers of 64, 4 heads, vocab 128."""
    kw.setdefault("vocab_size", 128)
    kw.setdefault("max_position_embeddings", 64)
    return BertConfig(hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=128, **kw)


def _gelu_approximate(cfg: BertConfig) -> bool:
    return cfg.hidden_act in ("gelu_new", "gelu_fast")


# ---------------------------------------------------------------- init

def init_bert(cfg: BertConfig, generator: torch.Generator,
              dtype=torch.float32, device="cuda") -> Params:
    """N(0, initializer_range^2) weights, zero biases, unit norms (JAX's
    layout; the numbers differ from JAX's for the same seed: tests carry
    weights across with ``utils.weights.params_from_numpy``)."""
    device = _build.resolve_device(device)
    d, std, v = cfg.hidden_size, cfg.initializer_range, cfg.padded_vocab_size
    kw = dict(dtype=dtype, device=device)
    lin = lambda d_in, d_out: dense.init_linear(generator, d_in, d_out,
                                                std=std, **kw)
    normal = lambda shape: dense._normal(generator, shape, std, dtype, device)
    layers = [{
        "Wqkv": lin(d, 3 * d),
        "out_proj": lin(d, d),
        "norm1": norms.init_layer_norm(d, **kw),
        "mlp": {"fc1": lin(d, cfg.intermediate_size),
                "fc2": lin(cfg.intermediate_size, d)},
        "norm2": norms.init_layer_norm(d, **kw),
    } for _ in range(cfg.num_hidden_layers)]
    return {
        "embeddings": {
            "word": normal((v, d)),
            "position": normal((cfg.max_position_embeddings, d)),
            "token_type": normal((cfg.type_vocab_size, d)),
            "ln": norms.init_layer_norm(d, **kw),
        },
        "layers": _stack(layers),
        "pooler": lin(d, d),
        "mlm": {
            "transform": lin(d, d),
            "ln": norms.init_layer_norm(d, **kw),
            "decoder_bias": torch.zeros(v, **kw),
        },
        "nsp": lin(d, 2),
    }


# ---------------------------------------------------------------- forward

def bert_embed(params: Params, cfg: BertConfig, input_ids: torch.Tensor,
               token_type_ids: Optional[torch.Tensor] = None,
               position_ids: Optional[torch.Tensor] = None, *,
               train: bool = False,
               rng: Optional[torch.Tensor] = None) -> torch.Tensor:
    """word + position + token type, then LN and dropout (JAX :107)."""
    e = params["embeddings"]
    s = input_ids.shape[1]
    hidden = e["word"][input_ids]
    if position_ids is None:
        position_ids = torch.arange(s, device=input_ids.device)[None, :]
    hidden = hidden + e["position"][position_ids]
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    hidden = hidden + e["token_type"][token_type_ids]
    hidden = norms.layer_norm(hidden, e["ln"]["weight"], e["ln"]["bias"],
                              cfg.layer_norm_eps)
    return norms.dropout(hidden, cfg.hidden_dropout_prob, rng,
                         deterministic=not train)


def _bert_block(hidden, lp, cfg: BertConfig, *, key_padding_mask,
                train: bool, rngs):
    """Post-norm block: h = LN(h + drop(attn(h))); h = LN(h + drop(mlp(h)))
    (JAX :126), the attention bidirectional through the flash wrapper
    (``mha``: K3, and K5 in the backward; a key padding mask takes the
    ragged entry, which is forward only on the card)."""
    b, s, d = hidden.shape
    r_attn, r_d1, r_d2 = (prng.split(rngs, 3) if rngs is not None
                          else (None, None, None))
    qkv = dense.linear(hidden, lp["Wqkv"])
    qkv = qkv.reshape(b, s, 3, cfg.num_attention_heads, cfg.head_dim)
    ctx = mha(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=False,
              key_padding_mask=key_padding_mask,
              dropout_p=cfg.attention_probs_dropout_prob, dropout_rng=r_attn,
              deterministic=not train)
    attn_out = dense.linear(ctx.reshape(b, s, d), lp["out_proj"])
    attn_out = norms.dropout(attn_out, cfg.hidden_dropout_prob, r_d1,
                             deterministic=not train)
    hidden = norms.layer_norm(hidden + attn_out, lp["norm1"]["weight"],
                              lp["norm1"]["bias"], cfg.layer_norm_eps)
    mlp_out = dense.linear(hidden, lp["mlp"]["fc1"])
    mlp_out = dense.gelu(mlp_out, approximate=_gelu_approximate(cfg))
    mlp_out = dense.linear(mlp_out, lp["mlp"]["fc2"])
    mlp_out = norms.dropout(mlp_out, cfg.hidden_dropout_prob, r_d2,
                            deterministic=not train)
    return norms.layer_norm(hidden + mlp_out, lp["norm2"]["weight"],
                            lp["norm2"]["bias"], cfg.layer_norm_eps)


def bert_forward(params: Params, cfg: BertConfig, input_ids: torch.Tensor, *,
                 token_type_ids: Optional[torch.Tensor] = None,
                 attention_mask: Optional[torch.Tensor] = None,
                 train: bool = False, rng: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (sequence_output (b, s, d), pooled_output (b, d)) (JAX :163).
    attention_mask: (b, s) True/1 = a real token, right-padded (``mha``
    reads it as per-sequence lengths). train with a key ``rng`` of
    ``utils.prng`` turns the dropout sites on."""
    kpm = attention_mask.to(torch.bool) if attention_mask is not None else None
    r_emb, r_layers = prng.split(rng) if rng is not None else (None, None)
    hidden = bert_embed(params, cfg, input_ids, token_type_ids, train=train,
                        rng=r_emb)
    layer_rngs = (prng.split(r_layers, cfg.num_hidden_layers)
                  if r_layers is not None else None)
    for li in range(cfg.num_hidden_layers):
        hidden = _bert_block(
            hidden, tree_index(params["layers"], li), cfg,
            key_padding_mask=kpm, train=train,
            rngs=None if layer_rngs is None else layer_rngs[li])
    pooled = torch.tanh(dense.linear(hidden[:, 0], params["pooler"]))
    return hidden, pooled


# ---------------------------------------------------------------- heads

def mlm_logits(params: Params, cfg: BertConfig,
               sequence_output: torch.Tensor) -> torch.Tensor:
    """transform (dense, activation, LN), then the tied word embedding and
    the decoder bias (JAX :200): f32 logits. bf16 weights multiply in bf16
    (the product rounded to bf16, where JAX keeps the f32 accumulator),
    f32 in f32."""
    h = dense.linear(sequence_output, params["mlm"]["transform"])
    h = dense.gelu(h, approximate=_gelu_approximate(cfg))
    h = norms.layer_norm(h, params["mlm"]["ln"]["weight"],
                         params["mlm"]["ln"]["bias"], cfg.layer_norm_eps)
    word = params["embeddings"]["word"]
    if h.dtype == torch.bfloat16 and word.dtype == torch.bfloat16:
        logits = (h @ word.T).float()
    else:
        logits = h.float() @ word.float().T
    return logits + params["mlm"]["decoder_bias"].float()


class BertPreTrainingOutput(NamedTuple):
    loss: Optional[torch.Tensor]
    prediction_logits: torch.Tensor
    seq_relationship_logits: torch.Tensor


def bert_for_pretraining(params: Params, cfg: BertConfig,
                         input_ids: torch.Tensor, *,
                         token_type_ids: Optional[torch.Tensor] = None,
                         attention_mask: Optional[torch.Tensor] = None,
                         labels: Optional[torch.Tensor] = None,
                         next_sentence_label: Optional[torch.Tensor] = None,
                         train: bool = False,
                         rng: Optional[torch.Tensor] = None,
                         masked_budget: Optional[int] = None
                         ) -> BertPreTrainingOutput:
    """MLM + NSP (JAX :222). labels: (b, s), -100 on unmasked positions.
    With ``cfg.dense_seq_output`` and labels the MLM head runs on a static
    gather of at most ``masked_budget`` masked positions of the whole batch
    (default s // 4), the first in batch-major order; the rest of the
    budget is padding with label -100."""
    seq_out, pooled = bert_forward(params, cfg, input_ids,
                                   token_type_ids=token_type_ids,
                                   attention_mask=attention_mask,
                                   train=train, rng=rng)
    nsp_logits = dense.linear(pooled, params["nsp"])
    if cfg.dense_seq_output and labels is not None:
        b, s = labels.shape
        budget = masked_budget or max(s // 4, 1)
        flat_labels = labels.reshape(-1)
        masked = flat_labels != -100
        idx = torch.argsort((~masked).to(torch.int8), stable=True)[:budget]
        sel_labels = torch.where(masked[idx], flat_labels[idx], -100)
        logits = mlm_logits(params, cfg, seq_out.reshape(b * s, -1)[idx])
        mlm_loss = cross_entropy_loss(logits, sel_labels, ignore_index=-100)
    else:
        logits = mlm_logits(params, cfg, seq_out)
        mlm_loss = (cross_entropy_loss(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
            ignore_index=-100) if labels is not None else None)
    loss = None
    if labels is not None:
        loss = mlm_loss
        if next_sentence_label is not None:
            loss = loss + cross_entropy_loss(nsp_logits, next_sentence_label)
    return BertPreTrainingOutput(loss=loss, prediction_logits=logits,
                                 seq_relationship_logits=nsp_logits)


# ---------------------------------------------------------------- HF import

def remap_hf_bert(state_dict, cfg: BertConfig, *, device="cuda",
                  dtype=None) -> Params:
    """A HuggingFace BertForPreTraining state dict (tensors or numpy
    arrays under HF's key names; ``transformers`` is not needed) in this
    layout (JAX :268): kernels transposed (out, in) -> (in, out), q, k and
    v fused into Wqkv, vocab rows padded to ``padded_vocab_size``, layers
    stacked. -> a tensor tree on ``device`` (dtype: cast the floats)."""
    A = lambda key: leaf_to_numpy(state_dict[key])
    v, vp = cfg.vocab_size, cfg.padded_vocab_size
    pad_vocab = lambda x: np.pad(x, ((0, vp - v),) + ((0, 0),) * (x.ndim - 1))
    lin = lambda p: {"kernel": A(p + ".weight").T, "bias": A(p + ".bias")}
    ln = lambda p: {"weight": A(p + ".weight"), "bias": A(p + ".bias")}
    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"bert.encoder.layer.{i}"
        qkv = [f"{p}.attention.self.{n}" for n in ("query", "key", "value")]
        layers.append({
            "Wqkv": {"kernel": np.concatenate([A(n + ".weight") for n in qkv], 0).T,
                     "bias": np.concatenate([A(n + ".bias") for n in qkv], 0)},
            "out_proj": lin(f"{p}.attention.output.dense"),
            "norm1": ln(f"{p}.attention.output.LayerNorm"),
            "mlp": {"fc1": lin(f"{p}.intermediate.dense"),
                    "fc2": lin(f"{p}.output.dense")},
            "norm2": ln(f"{p}.output.LayerNorm"),
        })
    tree = {
        "embeddings": {
            "word": pad_vocab(A("bert.embeddings.word_embeddings.weight")),
            "position": A("bert.embeddings.position_embeddings.weight"),
            "token_type": A("bert.embeddings.token_type_embeddings.weight"),
            "ln": ln("bert.embeddings.LayerNorm"),
        },
        "layers": stack_numpy(layers),
        "pooler": lin("bert.pooler.dense"),
        "mlm": {
            "transform": lin("cls.predictions.transform.dense"),
            "ln": ln("cls.predictions.transform.LayerNorm"),
            "decoder_bias": pad_vocab(A("cls.predictions.bias")),
        },
        "nsp": lin("cls.seq_relationship"),
    }
    return params_from_numpy(tree, device, dtype)
