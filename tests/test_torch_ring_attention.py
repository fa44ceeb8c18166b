"""The port's ring attention (parallel/ring_attention.py) and the ring forms
of K3's and K5's plain versions against the JAX package's, on the CPU.

The pair functions ``flash_fwd``/``flash_bwd`` (K3's and K5's plain
versions here) against JAX's ``_flash_fwd``/``_flash_bwd`` (their Pallas
bodies in interpret mode) at ring-pair offsets: a past chunk, the diagonal
with dropout and a batch-row offset, a future chunk (every key masked), and
per-sequence offsets with sq != sk. The dropout masks bit-equal to JAX's at
global positions (attention and the per-token sites' ``dropout_idx``). The
rings run over gloo worlds of 2 and 4 processes (``parallel/launch.py``,
the ranks' side in tests/torch_parallel_ranks.py, which imports no JAX)
against JAX's on virtual CPU devices. Tolerances in f32: the pair functions
1e-5; the rings' outputs and gradients JAX's own (atol 2e-5, rtol 2e-4,
tests/parallel/test_ring_attention.py).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from backpacks_flash_attn_tpu.ops import flash_attention as jfa
from backpacks_flash_attn_tpu.ops import norms as jnorms
from backpacks_flash_attn_tpu.parallel import ring_attention as jra
from backpacks_flash_attn_tpu_torch.ops import flash_attention as tfa
from backpacks_flash_attn_tpu_torch.ops import norms as tnorms
from backpacks_flash_attn_tpu_torch.parallel import launch
from backpacks_flash_attn_tpu_torch.parallel import ring_attention as tra
from backpacks_flash_attn_tpu_torch.utils import prng

torch.set_num_threads(1)

RANKS = str(Path(__file__).with_name("torch_parallel_ranks.py")) + ":run_cases"
PAIR_ATOL = 1e-5
ATOL, RTOL = 2e-5, 2e-4


def _np(t):
    return t.detach().numpy()


def _seed(key: int):
    return jax.random.key_data(jax.random.PRNGKey(key)).astype(jnp.uint32)


# ------------------------------------------------------------ pair functions

B, H, D, C = 2, 2, 16, 24       # chunks of C rows
# (q offsets, k offsets, sq, sk, dropout p, bh_offset)
PAIRS = {
    "past": (C, 0, C, C, 0.0, 0),
    "diagonal-dropout": (C, C, C, C, 0.25, 3),
    "future": (0, C, C, C, 0.2, 1),
    "ragged": ([40, 3], [8, 30], 20, 36, 0.3, 2),
}


def _pair_inputs(name):
    qo, ko, sq, sk, p, boff = PAIRS[name]
    rng = np.random.default_rng(sorted(PAIRS).index(name))
    q = rng.normal(size=(B, H, sq, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, H, sk, D)).astype(np.float32) for _ in range(2))
    offs = lambda o: np.broadcast_to(np.asarray(o, np.int32), (B,)).copy()
    return q, k, v, offs(qo), offs(ko), p, boff


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_flash_fwd_ring_pairs_match_jax(name):
    q, k, v, qo, ko, p, boff = _pair_inputs(name)
    scale = D ** -0.5
    jout, jlse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                None, scale, True, 128, 128, dropout_p=p,
                                seed=_seed(5), q_offsets=jnp.asarray(qo),
                                k_offsets=jnp.asarray(ko), bh_offset=boff)
    out, lse = tfa.flash_fwd(*(torch.from_numpy(x) for x in (q, k, v)), None,
                             scale, True, dropout_p=p, seed=prng.PRNGKey(5),
                             q_offsets=torch.from_numpy(qo),
                             k_offsets=torch.from_numpy(ko), bh_offset=boff)
    np.testing.assert_allclose(_np(out), np.asarray(jout), atol=PAIR_ATOL)
    np.testing.assert_allclose(_np(lse), np.asarray(jlse), atol=PAIR_ATOL,
                               rtol=1e-6)
    if name == "future":
        # no key of the pair is visible: a zero output and the NEG_INF lse,
        # so the ring's merge weighs the pair exp(NEG_INF - m) = 0
        assert (_np(out) == 0).all() and (_np(lse) == tfa.NEG_INF).all()


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_flash_bwd_ring_pairs_match_jax(name):
    """K5's plain version at sq != sk and ring offsets, fed out and lse of
    a longer attention (the rows over more keys than the pair's, as a ring
    backward feeds it the rows' global ones)."""
    q, k, v, qo, ko, p, boff = _pair_inputs(name)
    scale = D ** -0.5
    rng = np.random.default_rng(9)
    g = rng.normal(size=q.shape).astype(np.float32)
    # the global rows: every key from position 0 to the pair's chunk's end
    lead = rng.normal(size=(B, H, int(ko.max()), D)).astype(np.float32)
    kfull = np.concatenate([lead, k], axis=2)
    vfull = np.concatenate([lead[..., ::-1], v], axis=2)
    gout, glse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(kfull),
                                jnp.asarray(vfull), None, scale, True, 128, 128,
                                q_offsets=jnp.asarray(qo))
    want = jfa._flash_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), gout,
                          glse, jnp.asarray(g), _seed(6), scale, True, 128, 128,
                          dropout_p=p, q_offsets=jnp.asarray(qo),
                          k_offsets=jnp.asarray(ko), bh_offset=boff)[:3]
    got = tfa.flash_bwd(*(torch.from_numpy(x) for x in (q, k, v)),
                        torch.from_numpy(np.asarray(gout)),
                        torch.from_numpy(np.asarray(glse)), torch.from_numpy(g),
                        prng.PRNGKey(6), scale, True, dropout_p=p,
                        q_offsets=torch.from_numpy(qo),
                        k_offsets=torch.from_numpy(ko), bh_offset=boff)
    assert got[3] is None
    for t, j, n in zip(got[:3], want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=PAIR_ATOL,
                                   err_msg=n)
    if name == "future":
        assert all((_np(t) == 0).all() for t in got[:3])


def test_dropout_masks_bit_equal_jax():
    """The attention keep mask at ring offsets (bh = (bh_offset + b) * H +
    h, absolute query and key positions) and the per-token sites' mask at
    global element positions (``dropout_idx``), bit for bit."""
    seed = prng.seed_words(prng.PRNGKey(11))
    b, h, sq, sk, p = 3, 2, 7, 9, 0.3
    qo, ko, boff = np.array([5, 0, 17]), np.array([0, 4, 9]), 6
    got = tfa._keep_mask(seed, p, b, h, sq, sk, torch.from_numpy(qo), "cpu",
                         torch.from_numpy(ko), boff)
    bh = ((np.arange(b) + boff)[:, None] * h + np.arange(h))[:, :, None, None]
    qpos = (qo[:, None] + np.arange(sq))[:, None, :, None]
    kpos = (ko[:, None] + np.arange(sk))[:, None, None, :]
    want = jfa._dropout_keep_positions(_seed(11), jnp.asarray(bh),
                                       jnp.asarray(qpos), jnp.asarray(kpos), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the per-token sites: a chunk's (b, c, d) elements at their flat
    # positions in the unsharded (B, s, d) tensor
    idx = ((np.arange(2)[:, None] + 1) * 40 + np.arange(10, 15)[None, :]
           )[:, :, None] * 8 + np.arange(8)
    key = jax.random.key_data(jax.random.PRNGKey(12))
    want = jnorms._hash_mask(key, 0.2, idx.shape, jnp.asarray(idx, jnp.int32))
    got = tnorms.hash_mask(prng.seed_words(prng.PRNGKey(12)), 0.2, idx.shape,
                           idx=torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < got.numel()


def test_dropout_add_layer_norm_at_global_positions_matches_jax():
    """dropout_add_layer_norm(dropout_idx=) draws the mask at the given
    positions: values and gradients equal JAX's."""
    rng = np.random.default_rng(3)
    x, r = (rng.normal(size=(2, 5, 8)).astype(np.float32) for _ in range(2))
    w, bias = rng.normal(size=8).astype(np.float32), np.zeros(8, np.float32)
    idx = ((np.arange(2)[:, None] + 2) * 30 + 7 + np.arange(5)[None, :]
           )[:, :, None] * 8 + np.arange(8)

    def jf(x, r):
        out, res = jnorms.dropout_add_layer_norm(
            x, r, jnp.asarray(w), jnp.asarray(bias), 0.3, rng=jax.random.PRNGKey(4),
            deterministic=False, dropout_idx=jnp.asarray(idx, jnp.int32))
        return jnp.sum(out * 1.5) + jnp.sum(res), (out, res)

    (_, (jout, jres)), jg = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(r))
    tx, tr = (torch.from_numpy(a).requires_grad_() for a in (x, r))
    out, res = tnorms.dropout_add_layer_norm(
        tx, tr, torch.from_numpy(w), torch.from_numpy(bias), 0.3,
        rng=prng.PRNGKey(4), deterministic=False,
        dropout_idx=torch.from_numpy(idx))
    ((out * 1.5).sum() + res.sum()).backward()
    np.testing.assert_allclose(_np(out), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(_np(res), np.asarray(jres), atol=1e-6)
    for t, j in zip((tx, tr), jg):
        np.testing.assert_allclose(_np(t.grad), np.asarray(j), atol=1e-5)


# ------------------------------------------------------------ rings

def _qkvt(seed, b, s, h, d, dv=None):
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(2))
    v, t = (rng.normal(size=(b, s, h, dv or d)).astype(np.float32)
            for _ in range(2))
    return dict(q=q, k=k, v=v, t=t)


# name: (world, ring case for the ranks)
RINGS = {
    "einsum-causal-S2": (2, dict(entry="global", fn="einsum", seq=2,
                                 kw=dict(causal=True), **_qkvt(1, 2, 32, 2, 16))),
    "einsum-wide-values-S4": (4, dict(entry="global", fn="einsum", seq=4,
                                      kw=dict(causal=True, softmax_scale=0.3),
                                      **_qkvt(2, 2, 32, 3, 8, dv=24))),
    "flash-causal-S4": (4, dict(entry="global", fn="flash", seq=4,
                                kw=dict(impl="flash", causal=True),
                                **_qkvt(3, 2, 64, 2, 16))),
    "flash-noncausal-S2": (2, dict(entry="global", fn="flash", seq=2,
                                   kw=dict(impl="flash", causal=False),
                                   **_qkvt(4, 2, 48, 2, 16))),
    "zigzag-S4": (4, dict(entry="global", fn="zigzag", seq=4,
                          kw=dict(softmax_scale=0.2), **_qkvt(5, 2, 64, 2, 16))),
    "flash-dropout-S4": (4, dict(entry="local", fn="flash", seq=4, dropout_key=7,
                                 kw=dict(causal=True, dropout_p=0.3),
                                 **_qkvt(6, 2, 64, 2, 16))),
    "zigzag-einsum-dropout-S2": (2, dict(entry="local", fn="zigzag_einsum", seq=2,
                                         dropout_key=8,
                                         kw=dict(dropout_p=0.25, bh_offset=2),
                                         **_qkvt(7, 2, 32, 2, 16, dv=40))),
}


@pytest.fixture(scope="module")
def port_rings():
    """Every ring case on its world (one world of 2 ranks, one of 4), in
    rank order; local cases joined over the ranks."""
    out = {}
    for world in (2, 4):
        names = [n for n, (w, _) in RINGS.items() if w == world]
        cases = [dict(kind="ring", **RINGS[n][1]) for n in names]
        ranks = launch.run_world(RANKS, world, args=(cases,), threads=1,
                                 timeout=300)
        for i, n in enumerate(names):
            if RINGS[n][1]["entry"] == "global":
                out[n] = ranks[0][i]
                for r in ranks[1:]:       # every rank has the whole result
                    np.testing.assert_array_equal(r[i]["out"], out[n]["out"])
            else:
                cat = lambda xs: np.concatenate(xs, axis=1)
                out[n] = {"out": cat([r[i]["out"] for r in ranks]),
                          "grads": [cat([r[i]["grads"][j] for r in ranks])
                                    for j in range(3)]}
    return out


def _jax_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]).reshape(1, n), ("data", "seq"))


def _jax_ring(name):
    """JAX's output and gradients of sum(out * t) for the case."""
    world, c = RINGS[name]
    q, k, v, t = (jnp.asarray(c[x]) for x in "qkvt")
    mesh = _jax_mesh(c["seq"])
    kw = dict(c["kw"])
    if c["entry"] == "global":
        if c["fn"] == "zigzag":
            attn = jra.make_zigzag_ring_attention(mesh, **kw)
        else:
            attn = jra.make_ring_attention(mesh, **kw)
    else:
        fn = {"flash": jra.ring_flash_attention_local,
              "zigzag_einsum": jra.zigzag_ring_attention_local_einsum}[c["fn"]]
        kw["dropout_rng"] = jax.random.PRNGKey(c["dropout_key"])
        if c["fn"].startswith("zigzag"):
            q, k, v, t = (jra.zigzag_permute(x, c["seq"]) for x in (q, k, v, t))
        spec = P(None, "seq", None, None)
        attn = jax.shard_map(lambda q, k, v: fn(q, k, v, axis="seq", **kw),
                             mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                             check_vma=False)
    loss = lambda q, k, v: jnp.sum(attn(q, k, v) * t)
    with mesh:
        out = jax.jit(attn)(q, k, v)
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", list(RINGS))
def test_ring_matches_jax(port_rings, name):
    out, grads = _jax_ring(name)
    got = port_rings[name]
    np.testing.assert_allclose(got["out"], out, atol=ATOL, rtol=RTOL)
    for g, j, n in zip(got["grads"], grads, "qkv"):
        np.testing.assert_allclose(g, j, atol=ATOL, rtol=RTOL, err_msg=f"d{n}")


def test_ring_flash_dropout_matches_the_single_device_kernel(port_rings):
    """The flash ring with attention dropout over 4 ranks gives the
    single-device flash attention's output and gradients with the same key
    (the same masks: global positions), and it really drops."""
    c = RINGS["flash-dropout-S4"][1]
    q, k, v = (torch.from_numpy(c[x]).requires_grad_() for x in "qkv")
    out = tfa.flash_attention(q, k, v, causal=True, dropout_p=0.3,
                              dropout_rng=prng.PRNGKey(7))
    (out * torch.from_numpy(c["t"])).sum().backward()
    got = port_rings["flash-dropout-S4"]
    np.testing.assert_allclose(got["out"], _np(out), atol=ATOL, rtol=RTOL)
    for g, t in zip(got["grads"], (q, k, v)):
        np.testing.assert_allclose(g, _np(t.grad), atol=ATOL, rtol=RTOL)
    plain = tfa.flash_attention(q, k, v, causal=True)
    assert np.abs(got["out"] - _np(plain)).max() > 1e-2


def test_zigzag_order_matches_jax():
    for s, n in ((16, 2), (48, 4)):
        np.testing.assert_array_equal(tra.zigzag_order(s, n).numpy(),
                                      np.asarray(jra.zigzag_order(s, n)))
    x = torch.randn(2, 48, 3)
    np.testing.assert_array_equal(
        tra.zigzag_unpermute(tra.zigzag_permute(x, 4), 4).numpy(), x.numpy())
    with pytest.raises(ValueError):
        tra.zigzag_order(30, 4)
