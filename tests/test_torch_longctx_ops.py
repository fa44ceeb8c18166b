"""The port's long-context ops against the JAX package's, on the CPU in f32.

K7's plain version (``ops/fused_mlp.py``) against JAX's Pallas body in
interpret mode, token padding included; ``dense.mlp`` forward and
gradients with the fused-MLP switch off and on (set in both packages by
monkeypatch, in this file only); ``fused_mlp.supported`` case for case;
the block-sparse op (K9's plain versions) forward and q/k/v gradients
against JAX's in interpret mode (causal and not, a row with no active
tile, sq != sk, and the ragged forward); rotary against JAX (scalar and
per-row offsets, XPos). Tolerances: 1e-5 for the MLP and rotary
(elementwise, f32 sums of at most 512 terms), 5e-5 for attention and its
gradients (f32 sums taken in another order), 2e-4 for the MLP gradients
(sums over the tokens and the inner width, as JAX's own fused-MLP test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu.ops import dense as jdense
from backpacks_flash_attn_tpu.ops import flash_attention as jfa
from backpacks_flash_attn_tpu.ops import fused_mlp as jfm
from backpacks_flash_attn_tpu.ops import quant as jq
from backpacks_flash_attn_tpu.ops import rotary as jrot
from backpacks_flash_attn_tpu_torch.ops import _build
from backpacks_flash_attn_tpu_torch.ops import dense as tdense
from backpacks_flash_attn_tpu_torch.ops import flash_attention as tfa
from backpacks_flash_attn_tpu_torch.ops import fused_mlp as tfm
from backpacks_flash_attn_tpu_torch.ops import quant as tq
from backpacks_flash_attn_tpu_torch.ops import rotary as trot

torch.set_num_threads(1)

ATOL_ELEMENTWISE = 1e-5
ATOL_ATTENTION = 5e-5
ATOL_MLP_GRADS = 2e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _mlp_params(seed, d, inner, d_out=None):
    p = jdense.init_mlp(jax.random.PRNGKey(seed), d, inner, d_out)
    # non-zero biases, so that their gradients and the fused bias add count
    rng = np.random.default_rng(seed)
    for name in ("fc1", "fc2"):
        n = p[name]["bias"].shape[0]
        p[name]["bias"] = jnp.asarray(rng.normal(size=n).astype(np.float32) * 0.1)
    return p


def _torch_tree(p):
    return {k: {n: _t(v) for n, v in d.items()} for k, d in p.items()}


@pytest.mark.parametrize("t,activation,d", [
    (256, "gelu_new", 128),
    (1000, "sqrelu", 128),      # 1000: padding
    (40, "gelu", 1536),         # gpt3-large's width
])
def test_fused_mlp_plain_matches_pallas_interpret(t, activation, d):
    inner = 512
    p = _mlp_params(0, d, inner)
    x = np.random.default_rng(1).normal(size=(t, d)).astype(np.float32)
    args = (p["fc1"]["kernel"], p["fc1"]["bias"], p["fc2"]["kernel"],
            p["fc2"]["bias"])
    jout, jh = jfm.mlp_fwd_fused(jnp.asarray(x), *args, activation=activation,
                                 block_t=256, block_i=256)
    _build.reset_launches()
    tout, th = tfm.mlp_fwd_fused(_t(x), *(_t(a) for a in args),
                                 activation=activation)
    assert _build.launch_counts()["fused_mlp_fwd"] == 0
    assert tout.shape == (t, d) and th.shape == (t, inner)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh),
                               atol=ATOL_ELEMENTWISE, rtol=1e-5)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               atol=ATOL_ELEMENTWISE, rtol=1e-5)


@pytest.mark.parametrize("switch", [False, True])
def test_dense_mlp_fwd_and_grads_match_jax(monkeypatch, switch):
    """sum(sin(mlp(x))) and its gradients in x and every weight and bias,
    the switch set alike in both packages (on: JAX's Pallas body in
    interpret mode and K7's plain version; both backwards recompute from
    h_pre)."""
    monkeypatch.setattr(jdense, "_FUSED_MLP", switch)
    monkeypatch.setattr(tdense, "_FUSED_MLP", switch)
    d, inner = 128, 256
    p = _mlp_params(2, d, inner)
    x = np.random.default_rng(3).normal(size=(2, 48, d)).astype(np.float32)

    def loss(p, x):
        return jnp.sum(jnp.sin(jdense.mlp(x, p, "gelu_new")))

    jv, (jgp, jgx) = jax.value_and_grad(loss, argnums=(0, 1))(p, jnp.asarray(x))
    tp = {k: {n: v.requires_grad_() for n, v in d_.items()}
          for k, d_ in _torch_tree(p).items()}
    tx = _t(x).requires_grad_()
    tv = torch.sin(tdense.mlp(tx, tp, "gelu_new")).sum()
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               atol=ATOL_MLP_GRADS, rtol=0)
    for k in ("fc1", "fc2"):
        for n in ("kernel", "bias"):
            np.testing.assert_allclose(tp[k][n].grad.numpy(),
                                       np.asarray(jgp[k][n]),
                                       atol=ATOL_MLP_GRADS, rtol=0,
                                       err_msg=f"{k}.{n}")


def test_supported_matches_jax_case_for_case():
    good = _mlp_params(4, 128, 512)
    cases = {
        "good": (good, "gelu_new"),
        "bad activation": (good, "nope"),
        "odd width": (_mlp_params(4, 120, 512), "gelu_new"),
        "no bias": ({"fc1": {"kernel": good["fc1"]["kernel"]},
                     "fc2": good["fc2"]}, "gelu_new"),
        "wide output": (_mlp_params(4, 128, 256, 4096), "relu"),
        "square output": (_mlp_params(4, 128, 256, 2048), "sqrelu"),
        "inner 640": (_mlp_params(4, 128, 640), "gelu"),
        "gpt3-large widths": (_mlp_params(4, 1536, 512, 1536), "gelu_new"),
    }
    for name, (p, act) in cases.items():
        assert tfm.supported(_torch_tree(p), act) == jfm.supported(p, act), name
    jquant = {k: jq.quantize_linear_params(good[k], bits=8) for k in good}
    tquant = {k: tq.quantize_linear_params(_torch_tree(good)[k], bits=8)
              for k in good}
    assert not jfm.supported(jquant, "gelu_new")
    assert not tfm.supported(tquant, "gelu_new")


def _band(n_qb, n_kb, band):
    qi, kj = np.arange(n_qb)[:, None], np.arange(n_kb)[None, :]
    return (((kj <= qi) & ((qi - kj) < band)) | (kj == 0)).astype(np.int32)


@pytest.mark.parametrize("causal,sq,sk", [(True, 384, 384), (False, 384, 384),
                                          (False, 200, 330)])
def test_blocksparse_fwd_and_grads_match_jax(causal, sq, sk):
    """Query block 1 has no active tile (its rows give 0 and no
    gradient); JAX's custom_vjp against the port's autograd Function."""
    rng = np.random.default_rng(5)
    b, h, d, block = 2, 2, 16, 128
    q, g = (rng.normal(size=(b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, sk, h, d)).astype(np.float32) for _ in range(2))
    n_qb, n_kb = -(-sq // block), -(-sk // block)
    bm = _band(n_qb, n_kb, 2) if causal else (rng.random((n_qb, n_kb)) < 0.6
                                             ).astype(np.int32)
    bm[1] = 0
    kw = dict(causal=causal, softmax_scale=0.3, block_q=block, block_k=block)

    def jloss(q, k, v):
        o = jfa.flash_blocksparse_attention(q, k, v, jnp.asarray(bm), **kw)
        return jnp.sum(o * g), o

    (_, jo), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(*map(jnp.asarray, (q, k, v)))
    tq_, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    to = tfa.flash_blocksparse_attention(tq_, tk, tv, _t(bm), **kw)
    (to * _t(g)).sum().backward()
    assert (to[:, block:2 * block] == 0).all()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               atol=ATOL_ATTENTION, rtol=0)
    for name, a, want in zip("qkv", (tq_, tk, tv), jgrads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(want),
                                   atol=ATOL_ATTENTION, rtol=0,
                                   err_msg=f"d{name}")


def test_blocksparse_ragged_forward_and_lse_match_jax():
    """Per-row key lengths (forward only; one row 0, one past sk) and the
    LSE, with JAX's for an empty row: NEG_INF + log(1)."""
    rng = np.random.default_rng(6)
    b, s, h, d, block = 3, 320, 2, 16, 64
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))
    lens = np.array([0, 130, 999], np.int32)
    bm = _band(5, 5, 3)
    bm[2] = 0
    kw = dict(causal=True, softmax_scale=0.25, block_q=block, block_k=block)
    jo = jfa.flash_blocksparse_attention(*map(jnp.asarray, (q, k, v)),
                                         jnp.asarray(bm),
                                         seq_lengths=jnp.asarray(lens), **kw)
    to = tfa.flash_blocksparse_attention(*map(_t, (q, k, v)), _t(bm),
                                         seq_lengths=_t(lens), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo),
                               atol=ATOL_ATTENTION, rtol=0)
    # the LSE from the plain version of K9's forward, over the pre-scaled q
    tact = tfa.blocksparse_active(_t(bm), True, block, block)
    _, tlse = tfa.blocksparse_attention_ref(
        _t(q * 0.25), _t(k), _t(v), tact, causal=True, block_q=block,
        block_k=block, seq_lengths=_t(lens))
    pad = lambda x: jnp.pad(jnp.asarray(x.transpose(0, 2, 1, 3)),
                            ((0, 0), (0, 0), (0, 0), (0, 128 - d)))
    active = jfa._bs_active(jnp.asarray(bm, jnp.float32), True, 5, 5, block,
                            block)
    _, jlse = jfa._bs_fwd(pad(q * 0.25), pad(k), pad(v),
                          jnp.asarray(lens), active, s, s, block, block, True)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[..., 0],
                               atol=ATOL_ATTENTION, rtol=1e-6)
    assert (tlse[0] == tfa.NEG_INF).all() and (tlse[:, :, 128:192] == tfa.NEG_INF).all()


@pytest.mark.parametrize("offset,scale_base", [(3, 0), ("rows", 0),
                                               (5, 64), ("rows", 64)])
def test_rotary_matches_jax(offset, scale_base):
    rng = np.random.default_rng(7)
    q, k = (rng.normal(size=(3, 6, 2, 16)).astype(np.float32) for _ in range(2))
    off = np.array([0, 4, 17], np.int32) if offset == "rows" else offset
    jq_, jk = jrot.apply_rotary_qk(jnp.asarray(q), jnp.asarray(k), 12,
                                   seqlen_offset=jnp.asarray(off),
                                   scale_base=scale_base)
    tq_, tk = trot.apply_rotary_qk(_t(q), _t(k), 12,
                                   seqlen_offset=torch.as_tensor(off),
                                   scale_base=scale_base)
    np.testing.assert_allclose(tq_.numpy(), np.asarray(jq_),
                               atol=ATOL_ELEMENTWISE, rtol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                               atol=ATOL_ELEMENTWISE, rtol=1e-5)
    # the pass-through channels past the rotary dim are untouched
    assert torch.equal(tq_[..., 12:], _t(q)[..., 12:])
