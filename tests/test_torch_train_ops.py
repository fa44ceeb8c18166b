"""The training ops of the PyTorch port against the JAX package's, on the
CPU in f32.

The keys and dropout masks must be bit-equal to JAX's (the port draws them
from the same threefry keys and the same counter hash). Values and
gradients go through the JAX functions as its own tests run them (Pallas
in interpret mode) and through the port's plain versions, from the same
numpy-seeded inputs. Tolerances: 1e-5 for attention and the fused
contextualization (f32 sums in another order), 1e-5 for the LayerNorm
backward with f32 saves and 1e-2 with bf16 saves (the saved residual is
rounded to bf16 on both sides, at different points), 1e-6 for the cross
entropy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu.ops import backpack_kernels as jbk
from backpacks_flash_attn_tpu.ops import cross_entropy as jce
from backpacks_flash_attn_tpu.ops import flash_attention as jfa
from backpacks_flash_attn_tpu.ops import norms as jnorms
from backpacks_flash_attn_tpu_torch.ops import backpack_kernels as tbk
from backpacks_flash_attn_tpu_torch.ops import cross_entropy as tce
from backpacks_flash_attn_tpu_torch.ops import flash_attention as tfa
from backpacks_flash_attn_tpu_torch.ops import norms as tnorms
from backpacks_flash_attn_tpu_torch.utils import prng

torch.set_num_threads(1)


def _np(t):
    return t.detach().numpy()


def _leaf(a):
    return torch.tensor(a, requires_grad=True)


SPLITS, FOLDS = (2, 3, (4, 2)), (0, 5, 2 ** 31 + 3)


@jax.jit
def _jax_keys(seed):
    """JAX's key of ``seed``, its data, its splits and its folds, in one
    executable for every seed."""
    jk = jax.random.PRNGKey(seed)
    return (jax.random.key_data(jk), [jax.random.split(jk, n) for n in SPLITS],
            [jax.random.fold_in(jk, d) for d in FOLDS])


def test_prng_split_fold_in_key_data_bit_equal_to_jax():
    for seed in (0, 7, 2 ** 31 - 1):
        tk = prng.PRNGKey(seed)
        data, splits, folds = _jax_keys(seed)
        np.testing.assert_array_equal(np.asarray(data), prng.key_data(tk).numpy())
        for num, want in zip(SPLITS, splits):
            np.testing.assert_array_equal(np.asarray(want),
                                          prng.split(tk, num).numpy())
        for d, want in zip(FOLDS, folds):
            np.testing.assert_array_equal(np.asarray(want),
                                          prng.fold_in(tk, d).numpy())


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_dropout_masks_bit_equal_to_jax(rate):
    tkey = prng.fold_in(prng.PRNGKey(3), 11)
    bh = np.arange(6)[:, None, None]
    qp = np.arange(0, 400, 7)[None, :, None]
    kp = np.arange(90)[None, None, :]

    @jax.jit
    def masks(bh, qp, kp):
        key = jax.random.fold_in(jax.random.PRNGKey(3), 11)
        seed = jax.random.key_data(key).astype(jnp.uint32)
        return (jfa._dropout_keep_positions(seed, bh, qp, kp, rate),
                jnorms._hash_mask(jax.random.key_data(key), rate, (3, 5, 70)))

    want, want_hash = masks(bh, qp, kp)
    got = tfa.dropout_keep_positions(prng.seed_words(tkey), torch.tensor(bh),
                                     torch.tensor(qp), torch.tensor(kp), rate)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert abs(got.float().mean().item() - (1 - rate)) < 0.02
    want = want_hash
    got = tnorms.hash_mask(prng.seed_words(tkey), rate, (3, 5, 70))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_dropout_fwd_and_grads_match_jax(rng, causal):
    b, s, h, d = 2, 40, 3, 16
    q, k, v, g = (rng.normal(size=(b, s, h, d)).astype(np.float32)
                  for _ in range(4))
    kw = dict(causal=causal, softmax_scale=0.3, dropout_p=0.1)
    key = jax.random.PRNGKey(5)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, dropout_rng=key, **kw)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                   has_aux=True))(q, k, v)
    tq, tk, tv = _leaf(q), _leaf(k), _leaf(v)
    tout = tfa.flash_attention(tq, tk, tv, dropout_rng=prng.PRNGKey(5), **kw)
    (tout * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=1e-5)
    for name, jgr, t in zip("qkv", jgrads, (tq, tk, tv)):
        np.testing.assert_allclose(_np(t.grad), np.asarray(jgr), atol=1e-5,
                                   err_msg=f"d{name}")


def test_flash_attention_ref_dropout_offsets_match_jax_fwd(rng):
    """K3's plain version with dropout and per-sequence q_offsets, sq != sk
    and an empty sequence, against JAX's ``_flash_fwd`` (its Pallas body in
    interpret mode): out and LSE. The dropout hash takes the absolute query
    position q_offsets[b] + i, which K3 on the card hashes too."""
    b, sq, sk, h, d = 3, 12, 40, 2, 16
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, sk, h, d)).astype(np.float32)
            for _ in range(2))
    lens = np.array([40, 0, 29], np.int32)      # sequence 1 is empty
    offs = np.array([28, 0, 9], np.int32)
    scale, p = 0.3, 0.3

    @jax.jit
    def fwd(q, k, v, lens, offs):
        seed = jax.random.key_data(jax.random.PRNGKey(7)).astype(jnp.uint32)
        sw = lambda a: jnp.swapaxes(a, 1, 2)
        return jfa._flash_fwd(sw(q), sw(k), sw(v), lens, scale, True, 256, 256,
                              dropout_p=p, seed=seed, q_offsets=offs)

    jout, jlse = fwd(q, k, v, lens, offs)
    out, lse = tfa.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, softmax_scale=scale, seq_lengths=torch.from_numpy(lens),
        q_offsets=torch.from_numpy(offs), dropout_p=p,
        seed=prng.seed_words(prng.PRNGKey(7)), return_lse=True)
    np.testing.assert_allclose(_np(out), np.swapaxes(np.asarray(jout), 1, 2),
                               atol=1e-5)
    np.testing.assert_allclose(_np(lse), np.asarray(jlse), atol=1e-5,
                               rtol=1e-6)
    assert (_np(out)[1] == 0).all() and (_np(lse)[1] == tfa.NEG_INF).all()


def test_fused_contextualization_grads_match_jax(rng):
    b, s, nv, dnv, d = 2, 37, 3, 8, 24
    q, k = (rng.normal(size=(b, s, nv, dnv)).astype(np.float32)
            for _ in range(2))
    c = rng.normal(size=(b, s, nv, d)).astype(np.float32)
    g = rng.normal(size=(b, s, d)).astype(np.float32)

    def jloss(q, k, c):
        out = jbk.fused_contextualization(q, k, c, 0.4)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                   has_aux=True))(q, k, c)
    tq, tk, tc = _leaf(q), _leaf(k), _leaf(c)
    tout = tbk.fused_contextualization(tq, tk, tc, 0.4)
    (tout * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=1e-5)
    for name, jgr, t in zip(("q", "k", "content"), jgrads, (tq, tk, tc)):
        np.testing.assert_allclose(_np(t.grad), np.asarray(jgr), atol=1e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("bf16_saves,with_residual", [
    (False, True), (True, True), (True, False)])
def test_dropout_add_layer_norm_fwd_and_grads_match_jax(
        rng, monkeypatch, bf16_saves, with_residual):
    monkeypatch.setattr(jnorms, "_DALN_BF16_SAVES", bf16_saves)
    shape = (2, 9, 32)
    x, res, g1, g2 = (rng.normal(size=shape).astype(np.float32)
                      for _ in range(4))
    w = 1.0 + 0.1 * rng.normal(size=shape[-1:]).astype(np.float32)
    bias = 0.1 * rng.normal(size=shape[-1:]).astype(np.float32)
    key = jax.random.PRNGKey(9)

    def jloss(x, res, w, bias):
        normed, nr = jnorms.dropout_add_layer_norm(
            x, res if with_residual else None, w, bias, 0.2, 1e-5,
            rng=key, deterministic=False)
        return jnp.sum(normed * g1) + jnp.sum(nr * g2), (normed, nr)

    (_, (jn, jr)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(x, res, w, bias)
    tx, tres, tw, tb = _leaf(x), _leaf(res), _leaf(w), _leaf(bias)
    tn, tr = tnorms.dropout_add_layer_norm(
        tx, tres if with_residual else None, tw, tb, 0.2, 1e-5,
        rng=prng.PRNGKey(9), deterministic=False, bf16_saves=bf16_saves)
    ((tn * torch.from_numpy(g1)).sum()
     + (tr * torch.from_numpy(g2)).sum()).backward()
    np.testing.assert_allclose(_np(tn), np.asarray(jn), atol=1e-5)
    np.testing.assert_allclose(_np(tr), np.asarray(jr), atol=1e-5)
    atol = 1e-2 if bf16_saves and with_residual else 1e-5
    leaves = (tx, tres, tw, tb) if with_residual else (tx, None, tw, tb)
    for name, jgr, t in zip(("x", "residual", "weight", "bias"), jgrads,
                            leaves):
        if t is not None:
            np.testing.assert_allclose(_np(t.grad), np.asarray(jgr),
                                       atol=atol, err_msg=f"d{name}")


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_cross_entropy_loss_and_dlogits_match_jax(rng, label_smoothing):
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = -100
    labels[2, 6] = -100

    def jloss(lg):
        return jce.cross_entropy_loss(lg, labels,
                                      label_smoothing=label_smoothing)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(logits)
    tl = _leaf(logits)
    tloss = tce.cross_entropy_loss(tl, torch.from_numpy(labels).long(),
                                   label_smoothing=label_smoothing)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jl), atol=1e-6)
    np.testing.assert_allclose(_np(tl.grad), np.asarray(jg), atol=1e-6)
    per_tok, lse = tce.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels).long(),
                                     label_smoothing=label_smoothing)
    jper, jlse = jax.jit(lambda lg: jce.cross_entropy(
        lg, labels, label_smoothing=label_smoothing))(logits)
    np.testing.assert_allclose(per_tok.numpy(), np.asarray(jper), atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-6)
