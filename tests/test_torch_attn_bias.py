"""The additive score bias of K3 and its gradient in K5 (the port's plain
versions) against the JAX package, on the CPU in f32.

JAX's ``flash_attention(attn_bias=...)`` runs its Pallas kernels in
interpret mode, as its own tests run them (``tests/ops/test_flash_attention.py``
``test_flash_attn_bias``); the port's ``flash_attention`` takes its plain
version on CPU tensors. The same numpy-seeded inputs go to both. Tolerance
atol 5e-4, rtol 1e-3, that of the JAX package's own bias test (f32 sums in
another order; dbias of a broadcast bias sums up to b * h pairs). The JAX
calls are jitted, one executable a call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu.ops import flash_attention as jfa
from backpacks_flash_attn_tpu_torch.ops import attention as tattn
from backpacks_flash_attn_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

TOL = dict(atol=5e-4, rtol=1e-3)
B, S, H, D = 2, 96, 2, 32          # two 64-row blocks in JAX, the second ragged
BIAS_SHAPES = {"bh": (B, H, S, S), "1h": (1, H, S, S), "11": (1, 1, S, S),
               "2d": (S, S)}


def _inputs(seed, bias_shape):
    r = np.random.default_rng(seed)
    q, k, v, ct = (r.standard_normal((B, S, H, D)).astype(np.float32)
                   for _ in range(4))
    bias = r.standard_normal(bias_shape).astype(np.float32)
    return q, k, v, bias, ct


def test_flash_attention_bias_grid_matches_jax():
    """Forward and dq, dk, dv, dbias for each bias shape (b and h of their
    own, broadcast over b, over both, and 2-D), causal and not."""
    for i, (name, shape) in enumerate(BIAS_SHAPES.items()):
        for causal in (True, False):
            q, k, v, bias, ct = _inputs(10 * i + causal, shape)

            def jfn(q, k, v, bias, causal=causal):
                return jfa.flash_attention(q, k, v, causal=causal,
                                           attn_bias=bias, block_q=64,
                                           block_k=64)

            def jfwd_bwd(q, k, v, bias, ct, jfn=jfn):
                out, vjp = jax.vjp(jfn, q, k, v, bias)
                return out, vjp(ct)

            jout, jgrads = jax.jit(jfwd_bwd)(*(jnp.asarray(x)
                                               for x in (q, k, v, bias, ct)))
            tq, tk, tv, tb = (torch.tensor(x, requires_grad=True)
                              for x in (q, k, v, bias))
            tout = tfa.flash_attention(tq, tk, tv, causal=causal, attn_bias=tb)
            tout.backward(torch.tensor(ct))
            msg = f"bias {name} causal {causal}"
            np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                                       err_msg=msg, **TOL)
            for g, t, jg in zip("qkvb", (tq, tk, tv, tb), jgrads):
                assert t.grad.shape == t.shape, (msg, g)
                np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                           err_msg=f"{msg} d{g}", **TOL)


def test_flash_fwd_bwd_bias_pair_matches_jax():
    """The pair functions at JAX's signatures: ``flash_fwd(bias=)`` through
    the ragged entry (seq_lengths) and ``flash_bwd(bias=)``'s dbias, which
    is not summed over broadcast dims (JAX's ``_flash_bwd`` :794)."""
    q, k, v, bias, g = _inputs(7, (1, H, S, S))
    lens = np.array([S, 57], np.int32)
    jt = lambda x: jnp.swapaxes(jnp.asarray(x), 1, 2)
    tt = lambda x: torch.tensor(x).transpose(1, 2)
    scale = D ** -0.5
    jfwd = jax.jit(lambda q_, k_, v_, lens_, b_, causal: jfa._flash_fwd(
        q_, k_, v_, lens_, scale, causal, 64, 64, bias=b_), static_argnums=5)
    jout, jlse = jfwd(jt(q), jt(k), jt(v), jnp.asarray(lens), jnp.asarray(bias), False)
    tout, tlse = tfa.flash_fwd(tt(q), tt(k), tt(v), torch.tensor(lens), scale,
                               False, bias=torch.tensor(bias))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)
    # the backward pair on the full (unragged) forward
    jout, jlse = jfwd(jt(q), jt(k), jt(v), None, jnp.asarray(bias), True)
    jgr = jax.jit(lambda *a: jfa._flash_bwd(*a[:6], None, scale, True, 64, 64,
                                            bias=a[6]))(
        jt(q), jt(k), jt(v), jout, jlse, jt(g), jnp.asarray(bias))
    tout, tlse = tfa.flash_fwd(tt(q), tt(k), tt(v), None, scale, True,
                               bias=torch.tensor(bias))
    tgr = tfa.flash_bwd(tt(q), tt(k), tt(v), tout, tlse, tt(g), None, scale,
                        True, bias=torch.tensor(bias))
    assert tgr[3].shape == (B, H, S, S)
    for name, tg_, jg in zip(("dq", "dk", "dv", "dbias"), tgr, jgr):
        np.testing.assert_allclose(tg_.numpy(), np.asarray(jg), err_msg=name,
                                   **TOL)


def test_ragged_plain_route_stays_differentiable():
    """On CPU tensors the ragged entry is eager PyTorch: its gradients
    through q, k, v and the bias are those of the einsum reference under
    the same key padding (JAX cannot differentiate this entry at all)."""
    r = np.random.default_rng(3)
    q, k, v, ct = (torch.tensor(r.standard_normal((B, S, H, D)),
                                dtype=torch.float32) for _ in range(4))
    bias = torch.tensor(r.standard_normal((B, 1, S, S)), dtype=torch.float32)
    lens = torch.tensor([S, 40])
    mask = torch.arange(S)[None, :] < lens[:, None]
    leaves = [x.clone().requires_grad_() for x in (q, k, v, bias)]
    out = tfa.flash_attention(*leaves[:3], causal=False, seq_lengths=lens,
                              attn_bias=leaves[3])
    (out * ct).sum().backward()
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v, bias)]
    scale = D ** -0.5
    sc = torch.einsum("bthd,bshd->bhts", ref_leaves[0], ref_leaves[1]) * scale
    sc = torch.where(mask[:, None, None, :], sc + ref_leaves[3], -1e30)
    ref = torch.einsum("bhts,bshd->bthd", sc.softmax(-1), ref_leaves[2])
    (ref * ct).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), **TOL)
    for a, b_ in zip(leaves, ref_leaves):
        np.testing.assert_allclose(a.grad.numpy(), b_.grad.numpy(), **TOL)
    # the key-padding mask of mha reaches the same ragged entry
    tout = tattn.mha(q, k, v, causal=False, key_padding_mask=mask)
    np.testing.assert_allclose(
        tout.numpy(), tattn.mha_reference(q, k, v, causal=False,
                                          key_padding_mask=mask).numpy(),
        **TOL)
