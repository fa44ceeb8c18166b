"""BERT (``models/bert.py``), the key padding mask of ``mha`` and
``gpt_forward``, ``ops/softmax.py`` and ``utils/padding.py`` of the PyTorch
port against the JAX package, on the CPU in f32 at ``bert_test()``'s size.

The JAX side runs as its own tests run it: attention through its flash
kernels in interpret mode (``use_flash=True``), the ragged entry for a
padded batch and the dropout kernels in training; the port's attention
takes its plain versions on CPU tensors. Weights cross as numpy
(``utils.weights.params_from_numpy``). Dropout masks are bit-equal (the
keys split as JAX's), so the training loss matches too. Every JAX call is
jitted: one executable a call, not one an op (XLA:CPU faults after too
many executables in one worker process). Tolerances: 1e-5 on values (f32
sums in another order), 1e-4 relative on gradients (summed over the whole
batch and every layer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu import config as jconfig
from backpacks_flash_attn_tpu.models import bert as jbert
from backpacks_flash_attn_tpu.models import gpt as jgpt
from backpacks_flash_attn_tpu.ops import attention as jattn
from backpacks_flash_attn_tpu.ops import softmax as jsoftmax
from backpacks_flash_attn_tpu.utils import padding as jpadding
from backpacks_flash_attn_tpu_torch import config as tconfig
from backpacks_flash_attn_tpu_torch.models import bert as tbert
from backpacks_flash_attn_tpu_torch.models import gpt as tgpt
from backpacks_flash_attn_tpu_torch.ops import attention as tattn
from backpacks_flash_attn_tpu_torch.ops import softmax as tsoftmax
from backpacks_flash_attn_tpu_torch.utils import padding as tpadding
from backpacks_flash_attn_tpu_torch.utils import prng
from backpacks_flash_attn_tpu_torch.utils.weights import (params_from_numpy,
                                                          params_to_numpy)

torch.set_num_threads(1)

VAL = dict(atol=1e-5, rtol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees(t_tree, j_tree, **tol):
    flat_t = jax.tree_util.tree_leaves_with_path(t_tree)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(j_tree))
    assert len(flat_t) == len(flat_j)
    for path, leaf in flat_t:
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(flat_j[path]),
                                   err_msg=jax.tree_util.keystr(path), **tol)


@pytest.fixture(scope="module")
def bert_pair():
    cfg = jbert.bert_test(pad_vocab_size_multiple=8)
    jparams = jax.jit(jbert.init_bert, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    tcfg = tbert.bert_test(pad_vocab_size_multiple=8)
    return cfg, jparams, tcfg, params_from_numpy(_np_tree(jparams), "cpu")


def test_bert_forward_right_padded_mask_matches_jax(bert_pair):
    cfg, jparams, tcfg, tparams = bert_pair
    r = np.random.default_rng(0)
    b, s = 3, 24
    ids = r.integers(0, cfg.vocab_size, (b, s))
    tt = r.integers(0, 2, (b, s))
    lens = np.array([24, 17, 5])
    mask = np.arange(s)[None, :] < lens[:, None]
    jseq, jpool = jax.jit(lambda p, i, t, m: jbert.bert_forward(
        p, cfg, i, token_type_ids=t, attention_mask=m))(
            jparams, jnp.asarray(ids), jnp.asarray(tt), jnp.asarray(mask))
    tseq, tpool = tbert.bert_forward(tparams, tcfg, torch.tensor(ids),
                                     token_type_ids=torch.tensor(tt),
                                     attention_mask=torch.tensor(mask))
    np.testing.assert_allclose(tseq.numpy(), np.asarray(jseq), **VAL)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), **VAL)
    # the real tokens do not see the pad tokens
    ids2 = ids.copy()
    ids2[1, 20] = (ids2[1, 20] + 1) % cfg.vocab_size
    tseq2, _ = tbert.bert_forward(tparams, tcfg, torch.tensor(ids2),
                                  token_type_ids=torch.tensor(tt),
                                  attention_mask=torch.tensor(mask))
    np.testing.assert_allclose(tseq2[1, :17].numpy(), tseq[1, :17].numpy(),
                               atol=1e-6)


def test_bert_pretraining_loss_and_grads_match_jax(bert_pair):
    """bert_for_pretraining in training (hidden and attention dropout on,
    no mask): the loss with dense_seq_output's static gather (a budget
    smaller than the masked count, so the gather cuts) and NSP, and its
    gradient in every leaf; then the full head's loss in eval."""
    cfg, jparams, tcfg, tparams = bert_pair
    r = np.random.default_rng(1)
    b, s = 2, 32
    ids = r.integers(0, cfg.vocab_size, (b, s))
    labels = np.where(r.random((b, s)) < 0.3, r.integers(0, cfg.vocab_size,
                                                         (b, s)), -100)
    nsp = np.array([0, 1])
    dcfg = jbert.bert_test(pad_vocab_size_multiple=8, dense_seq_output=True)
    tdcfg = tbert.bert_test(pad_vocab_size_multiple=8, dense_seq_output=True)
    budget = int((labels != -100).sum()) - 3

    def jloss(p):
        return jbert.bert_for_pretraining(
            p, dcfg, jnp.asarray(ids), labels=jnp.asarray(labels),
            next_sentence_label=jnp.asarray(nsp), train=True,
            rng=jax.random.PRNGKey(7), masked_budget=budget).loss

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    leaves = params_from_numpy(_np_tree(jparams), "cpu")
    leaves = jax.tree.map(lambda t: t.requires_grad_(), leaves)
    out = tbert.bert_for_pretraining(
        leaves, tdcfg, torch.tensor(ids), labels=torch.tensor(labels),
        next_sentence_label=torch.tensor(nsp), train=True,
        rng=prng.PRNGKey(7), masked_budget=budget)
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(jl), rtol=1e-5)
    assert out.prediction_logits.shape == (budget, cfg.padded_vocab_size)
    _assert_trees(jax.tree.map(lambda t: t.grad.numpy(), leaves), _np_tree(jg),
                  atol=1e-6, rtol=1e-4)
    # the full head (every position), eval
    jfull = jax.jit(lambda p: jbert.bert_for_pretraining(
        p, cfg, jnp.asarray(ids), labels=jnp.asarray(labels),
        next_sentence_label=jnp.asarray(nsp)))(jparams)
    tfull = tbert.bert_for_pretraining(tparams, tcfg, torch.tensor(ids),
                                       labels=torch.tensor(labels),
                                       next_sentence_label=torch.tensor(nsp))
    np.testing.assert_allclose(tfull.loss.item(), float(jfull.loss), rtol=1e-5)
    np.testing.assert_allclose(tfull.prediction_logits.numpy(),
                               np.asarray(jfull.prediction_logits), **VAL)
    np.testing.assert_allclose(tfull.seq_relationship_logits.numpy(),
                               np.asarray(jfull.seq_relationship_logits), **VAL)


def _hf_bert_state_dict(cfg, seed):
    """A synthetic HF BertForPreTraining state dict at cfg's sizes."""
    r = np.random.default_rng(seed)
    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    a = lambda *shape: r.standard_normal(shape).astype(np.float32)
    sd = {"bert.embeddings.word_embeddings.weight": a(v, d),
          "bert.embeddings.position_embeddings.weight":
              a(cfg.max_position_embeddings, d),
          "bert.embeddings.token_type_embeddings.weight":
              a(cfg.type_vocab_size, d),
          "cls.predictions.bias": a(v), "cls.seq_relationship.weight": a(2, d),
          "cls.seq_relationship.bias": a(2)}
    for name in ("bert.embeddings.LayerNorm",
                 "cls.predictions.transform.LayerNorm"):
        sd[name + ".weight"], sd[name + ".bias"] = a(d), a(d)
    for name in ("bert.pooler.dense", "cls.predictions.transform.dense"):
        sd[name + ".weight"], sd[name + ".bias"] = a(d, d), a(d)
    for i in range(cfg.num_hidden_layers):
        p = f"bert.encoder.layer.{i}"
        for name, (o, n) in {"attention.self.query": (d, d),
                             "attention.self.key": (d, d),
                             "attention.self.value": (d, d),
                             "attention.output.dense": (d, d),
                             "intermediate.dense": (f, d),
                             "output.dense": (d, f)}.items():
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = a(o, n), a(o)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = a(d), a(d)
    return sd


def test_remap_hf_bert_matches_jax():
    cfg = jbert.bert_test(pad_vocab_size_multiple=8)
    tcfg = tbert.bert_test(pad_vocab_size_multiple=8)
    sd = _hf_bert_state_dict(cfg, 5)
    jtree = _np_tree(jbert.remap_hf_bert(sd, cfg))
    tsd = {k: torch.tensor(v) for k, v in sd.items()}
    _assert_trees(params_to_numpy(tbert.remap_hf_bert(tsd, tcfg, device="cpu")),
                  jtree, atol=0, rtol=0)
    _assert_trees(params_to_numpy(tbert.remap_hf_bert(sd, tcfg, device="cpu")),
                  jtree, atol=0, rtol=0)


def test_gpt_forward_key_padding_mask_matches_jax():
    cfg = jconfig.gpt2_test()
    jparams = jax.jit(jgpt.init_gpt, static_argnums=0)(cfg, jax.random.PRNGKey(2))
    tparams = params_from_numpy(_np_tree(jparams), "cpu")
    r = np.random.default_rng(2)
    ids = r.integers(0, cfg.vocab_size, (2, 20))
    mask = np.arange(20)[None, :] < np.array([[20], [13]])
    jh = jax.jit(lambda p, i, m: jgpt.gpt_forward(p, cfg, i, key_padding_mask=m))(
        jparams, jnp.asarray(ids), jnp.asarray(mask))
    th = tgpt.gpt_forward(tparams, tconfig.gpt2_test(), torch.tensor(ids),
                          key_padding_mask=torch.tensor(mask))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5,
                               rtol=1e-5)


def test_mha_reference_dropout_and_masks_match_jax():
    """The reference attention with JAX's bernoulli dropout (bit-equal
    keep mask), a key padding mask and a per-sequence causal offset."""
    r = np.random.default_rng(4)
    q, k, v = (r.standard_normal((2, 6, 3, 8)).astype(np.float32)
               for _ in range(3))
    mask = np.array([[1] * 6, [1] * 4 + [0] * 2], bool)
    for kw in (dict(causal=False, key_padding_mask=mask),
               dict(causal=True, q_offset=np.array([0, 2]))):
        jkw = {k_: jnp.asarray(x) if isinstance(x, np.ndarray) else x
               for k_, x in kw.items()}
        tkw = {k_: torch.tensor(x) if isinstance(x, np.ndarray) else x
               for k_, x in kw.items()}
        jout = jax.jit(lambda q_, k_, v_, jkw=jkw: jattn.mha_reference(
            q_, k_, v_, dropout_p=0.3, dropout_rng=jax.random.PRNGKey(9),
            deterministic=False, **jkw))(*map(jnp.asarray, (q, k, v)))
        tout = tattn.mha_reference(*map(torch.tensor, (q, k, v)), dropout_p=0.3,
                                   dropout_rng=prng.PRNGKey(9),
                                   deterministic=False, **tkw)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **VAL)
    jkeep = jax.jit(lambda k_: jax.random.bernoulli(k_, 0.7, (4, 5, 6)))(
        jax.random.PRNGKey(3))
    tkeep = prng.bernoulli(prng.PRNGKey(3), 0.7, (4, 5, 6))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))


def test_softmax_and_padding_match_jax():
    r = np.random.default_rng(6)
    x = r.standard_normal((2, 3, 5, 7)).astype(np.float32)
    mask = r.random((2, 1, 5, 7)) < 0.3
    for fn, args in ((jsoftmax.scaled_masked_softmax, (mask, 0.5)),
                     (jsoftmax.scaled_masked_softmax, (None, 2.0)),
                     (jsoftmax.scaled_upper_triang_masked_softmax, (0.7,))):
        tfn = getattr(tsoftmax, fn.__name__)
        jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
        targs = [torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args]
        want = jax.jit(lambda x_, fn=fn, jargs=jargs: fn(x_, *jargs))(jnp.asarray(x))
        np.testing.assert_allclose(tfn(torch.tensor(x), *targs).numpy(),
                                   np.asarray(want), **VAL)
    for causal in (True, False):
        jm = jsoftmax.FusedScaleMaskSoftmax(causal=causal, scale=0.3)
        tm = tsoftmax.FusedScaleMaskSoftmax(causal=causal, scale=0.3)
        np.testing.assert_allclose(
            tm(torch.tensor(x), torch.tensor(mask)).numpy(),
            np.asarray(jax.jit(jm)(jnp.asarray(x), jnp.asarray(mask))), **VAL)
    # unpad / pad / index_first_axis: the same order, bit-equal
    h = r.standard_normal((3, 6, 4)).astype(np.float32)
    pmask = np.arange(6)[None, :] < np.array([[6], [2], [4]])
    for budget in (None, 10, 14):
        ju = jax.jit(jpadding.unpad_input, static_argnums=2)(
            jnp.asarray(h), jnp.asarray(pmask), budget)
        tu = tpadding.unpad_input(torch.tensor(h), torch.tensor(pmask), budget)
        for name, tv, jv in zip(ju._fields, tu, ju):
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv),
                                          err_msg=name)
        np.testing.assert_array_equal(
            tpadding.pad_input(tu, 3, 6).numpy(),
            np.asarray(jax.jit(jpadding.pad_input, static_argnums=(1, 2))(ju, 3, 6)))
    idx = np.array([2, 0, 1, 2])
    np.testing.assert_array_equal(
        tpadding.index_first_axis(torch.tensor(h), torch.tensor(idx)).numpy(),
        np.asarray(jax.jit(jpadding.index_first_axis)(jnp.asarray(h), jnp.asarray(idx))))
