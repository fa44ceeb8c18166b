"""ViT (``models/vit.py``) of the PyTorch port against the JAX package, on
the CPU in f32 at ``vit_test()``'s size.

The JAX side runs its attention through its flash kernels in interpret
mode, as its own tests run them with ``use_flash=True``; the port's takes
its plain versions on CPU tensors. Weights cross as numpy. Every JAX
call is jitted (one executable a call, not one an op). Tolerances:
1e-5 on values (f32 sums in another order), 1e-4 relative on gradients
(summed over the whole batch and every layer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu.models import vit as jvit
from backpacks_flash_attn_tpu_torch.models import vit as tvit
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
def vit_pair():
    cfg = jvit.vit_test()
    jparams = jax.jit(jvit.init_vit, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    # a CLS token of its own (init_vit's is zeros)
    jparams["cls_token"] = jax.random.normal(jax.random.PRNGKey(1), (1, 1, 64))
    return cfg, jparams, tvit.vit_test(), params_from_numpy(_np_tree(jparams),
                                                            "cpu")


def _images(seed, b, cfg):
    r = np.random.default_rng(seed)
    return r.standard_normal((b, cfg.num_channels, cfg.image_size,
                              cfg.image_size)).astype(np.float32)


def test_vit_forward_matches_jax(vit_pair):
    cfg, jparams, tcfg, tparams = vit_pair
    img = _images(0, 3, cfg)
    jfeat = jax.jit(lambda p, x: jvit.vit_features(p, cfg, x))(jparams, jnp.asarray(img))
    tfeat = tvit.vit_features(tparams, tcfg, torch.tensor(img))
    assert tfeat.shape == (3, cfg.num_patches + 1, cfg.hidden_size)
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(jfeat), **VAL)
    np.testing.assert_allclose(
        tvit.vit_forward(tparams, tcfg, torch.tensor(img)).numpy(),
        np.asarray(jax.jit(lambda p, x: jvit.vit_forward(p, cfg, x))(
            jparams, jnp.asarray(img))), **VAL)


def test_vit_training_grads_match_jax(vit_pair):
    """A classification loss through vit_forward in training with the
    residual and attention dropout on (keys split as JAX's): the loss and
    every leaf's gradient."""
    _, jparams, _, _ = vit_pair
    cfg = jvit.vit_test(drop_rate=0.1, attn_drop_rate=0.2)
    tcfg = tvit.vit_test(drop_rate=0.1, attn_drop_rate=0.2)
    img = _images(1, 2, cfg)
    y = np.array([3, 7])

    def jloss(p):
        logits = jvit.vit_forward(p, cfg, jnp.asarray(img), train=True,
                                  rng=jax.random.PRNGKey(4))
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(2), y])

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    leaves = jax.tree.map(lambda t: t.requires_grad_(),
                          params_from_numpy(_np_tree(jparams), "cpu"))
    logits = tvit.vit_forward(leaves, tcfg, torch.tensor(img), train=True,
                              rng=prng.PRNGKey(4))
    loss = torch.nn.functional.cross_entropy(logits, torch.tensor(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    _assert_trees(jax.tree.map(lambda t: t.grad.numpy(), leaves), _np_tree(jg),
                  atol=1e-6, rtol=1e-4)


def test_patchify_matches_conv():
    """patchify + a GEMM over the (c, ph, pw)-flattened kernel is the
    stride-p convolution, and the patch order is row-major over the grid;
    bit-equal to JAX's patchify."""
    cfg = tvit.vit_test()
    r = np.random.default_rng(2)
    img = torch.tensor(_images(2, 2, cfg))
    w = torch.tensor(r.standard_normal((64, 3, 4, 4)).astype(np.float32))
    conv = torch.nn.functional.conv2d(img, w, stride=4)          # (b, d, 4, 4)
    via = tvit.patchify(img, 4) @ w.reshape(64, -1).T
    np.testing.assert_allclose(via.numpy(),
                               conv.flatten(2).transpose(1, 2).numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tvit.patchify(img, 4).numpy(),
                                  np.asarray(jax.jit(jvit.patchify, static_argnums=1)(
                                      jnp.asarray(img.numpy()), 4)))


def test_remap_hf_vit_matches_jax():
    cfg, tcfg = jvit.vit_test(), tvit.vit_test()
    r = np.random.default_rng(3)
    a = lambda *shape: r.standard_normal(shape).astype(np.float32)
    d, f, p = cfg.hidden_size, cfg.intermediate_size, cfg.patch_size
    sd = {"vit.embeddings.patch_embeddings.projection.weight":
              a(d, cfg.num_channels, p, p),
          "vit.embeddings.patch_embeddings.projection.bias": a(d),
          "vit.embeddings.cls_token": a(1, 1, d),
          "vit.embeddings.position_embeddings": a(1, cfg.num_patches + 1, d),
          "vit.layernorm.weight": a(d), "vit.layernorm.bias": a(d),
          "classifier.weight": a(cfg.num_classes, d),
          "classifier.bias": a(cfg.num_classes)}
    for i in range(cfg.num_hidden_layers):
        pre = f"vit.encoder.layer.{i}"
        for name, (o, n) in {"attention.attention.query": (d, d),
                             "attention.attention.key": (d, d),
                             "attention.attention.value": (d, d),
                             "attention.output.dense": (d, d),
                             "intermediate.dense": (f, d),
                             "output.dense": (d, f)}.items():
            sd[f"{pre}.{name}.weight"], sd[f"{pre}.{name}.bias"] = a(o, n), a(o)
        for name in ("layernorm_before", "layernorm_after"):
            sd[f"{pre}.{name}.weight"], sd[f"{pre}.{name}.bias"] = a(d), a(d)
    jtree = _np_tree(jvit.remap_hf_vit(sd, cfg))
    tsd = {k: torch.tensor(v) for k, v in sd.items()}
    _assert_trees(params_to_numpy(tvit.remap_hf_vit(tsd, tcfg, device="cpu")),
                  jtree, atol=0, rtol=0)
