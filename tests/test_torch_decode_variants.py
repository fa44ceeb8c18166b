"""K1's three redesigns and the rest of the decode-attention op surface,
against the JAX package's, on the CPU in f32.

The plain versions of ``decode_attention_gathered``, ``_selector`` and
``_blockdiag`` (``ops/decode_attention.py``) against JAX's Pallas kernels
run in interpret mode, as tests/ops/test_decode_attention.py runs them, on
ragged lengths with a zero-length row: the gathered form gives 0 there, the
other two attend uniformly, as JAX's do. Then ``decode_attention_flat``'s
``length_buckets``, JAX's direct K8 entries (int4 and mixed, a zero-length
row giving 0), the (b, S, h, dh) cache attention of ``ops/attention.py``
and the packed-QKV entries. Tolerance: atol 2e-4 / rtol 1e-3, the JAX
tests' own (f32 sums in another order; the gathered form's online softmax
rescales by blocks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu.ops import attention as jattn
from backpacks_flash_attn_tpu.ops import decode_attention as jda
from backpacks_flash_attn_tpu.ops import flash_attention as jfa
from backpacks_flash_attn_tpu_torch.config import gpt2_test
from backpacks_flash_attn_tpu_torch.ops import _build
from backpacks_flash_attn_tpu_torch.ops import attention as tattn
from backpacks_flash_attn_tpu_torch.ops import decode_attention as tda
from backpacks_flash_attn_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

ATOL, RTOL = 2e-4, 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=ATOL, rtol=RTOL)


def _k1_problem(quant, e, s, dk, dv, seed):
    """K1's operands (numpy): q (e, dk), kt (e, dk, s), v (e, s, dv), int8
    with (e, s) scales when quant, else f32 without."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(e, dk)).astype(np.float32)
    if quant:
        kt = rng.integers(-127, 127, (e, dk, s)).astype(np.int8)
        v = rng.integers(-127, 127, (e, s, dv)).astype(np.int8)
        ks = rng.uniform(0.01, 0.1, (e, s)).astype(np.float32)
        vs = rng.uniform(0.01, 0.1, (e, s)).astype(np.float32)
    else:
        kt = rng.normal(size=(e, dk, s)).astype(np.float32)
        v = rng.normal(size=(e, s, dv)).astype(np.float32)
        ks = vs = None
    lens = rng.integers(1, s + 1, (e,)).astype(np.int32)
    lens[:3] = (0, s, 1)
    return q, kt, ks, v, vs, lens


def _both(args):
    """The same operands for JAX and for the port (None stays None)."""
    return ([None if a is None else jnp.asarray(a) for a in args],
            [None if a is None else _t(a) for a in args])


@pytest.mark.parametrize("quant,s,block_s", [
    (False, 512, 128),
    (True, 512, 128),
    (True, 320, 128),     # not a multiple of 128: one block of the whole width
    (False, 384, 256),    # halved to 128
])
def test_gathered_plain_matches_pallas(quant, s, block_s):
    args = _k1_problem(quant, 16, s, 64, 128, seed=7)
    jargs, targs = _both(args)
    want = jda.decode_attention_gathered(*jargs, block_s=block_s)
    got = tda.decode_attention_gathered(*targs, block_s=block_s)
    assert got.shape == (16, 128) and got.dtype == torch.float32
    assert got[0].abs().max().item() == 0.0 and np.abs(np.asarray(want[0])).max() == 0.0
    _close(got, want)
    # K1's plain version agrees on every row with a valid position
    _close(got[1:], tda.decode_attention_ref(*targs)[1:])


@pytest.mark.parametrize("quant,v_transposed,e", [
    (False, False, 16),
    (True, True, 16),
    (True, False, 12),    # 12 rows: rows_per_program 8 halves to 4
])
def test_selector_plain_matches_pallas(quant, v_transposed, e):
    q, kt, ks, v, vs, lens = _k1_problem(quant, e, 256, 64, 128, seed=9)
    vin = np.ascontiguousarray(np.swapaxes(v, 1, 2)) if v_transposed else v
    jargs, targs = _both((q, kt, ks, vin, vs, lens))
    want = jda.decode_attention_selector(*jargs, v_transposed=v_transposed)
    got = tda.decode_attention_selector(*targs, v_transposed=v_transposed)
    assert got.shape == (e, 128)
    _close(got, want)
    # the zero-length row attends uniformly over all S columns, as K1 does
    _close(got[:1], tda.decode_attention_ref(*_both((q, kt, ks, v, vs, lens))[1])[:1])


@pytest.mark.parametrize("quant,rows_per_program,e", [
    (False, None, 16),
    (True, 8, 16),
    (True, None, 20),     # JAX's rule: 8 rows, halved to 4
])
def test_blockdiag_plain_matches_pallas(quant, rows_per_program, e):
    args = _k1_problem(quant, e, 256, 64, 128, seed=11)
    jargs, targs = _both(args)
    want = jda.decode_attention_blockdiag(*jargs, rows_per_program=rows_per_program)
    got = tda.decode_attention_blockdiag(*targs, rows_per_program=rows_per_program)
    _close(got, want)
    _close(got[:1], tda.decode_attention_ref(*targs)[:1])


def test_redesigns_take_plain_path_on_cpu_and_count_no_launch():
    q, kt, ks, v, vs, lens = (_t(a) for a in _k1_problem(True, 8, 64, 16, 32, 1))
    _build.reset_launches()
    for fn, ref in ((tda.decode_attention_gathered, tda.decode_attention_gathered_ref),
                    (tda.decode_attention_selector, tda.decode_attention_selector_ref),
                    (tda.decode_attention_blockdiag, tda.decode_attention_blockdiag_ref)):
        qb = q.bfloat16()
        assert torch.equal(fn(qb, kt, ks, v, vs, lens), ref(qb, kt, ks, v, vs, lens))
    counts = _build.launch_counts()
    assert all(counts[f"decode_attention_{k}"] == 0
               for k in ("gathered", "selector", "blockdiag"))


def test_flat_length_buckets_match_full_and_jax():
    """JAX's bucket boundaries (tests/ops/test_decode_attention.py:48):
    length_buckets=True equals False exactly, both equal JAX's flat form."""
    rng = np.random.default_rng(0)
    E, dk, S = 8, 16, 512
    q = rng.normal(size=(E, dk)).astype(np.float32)
    kt = rng.normal(size=(E, dk, S)).astype(np.float32)
    v = rng.normal(size=(E, S, dk)).astype(np.float32)
    vs = rng.uniform(0.5, 1.5, (E, S)).astype(np.float32)
    jargs, targs = _both((q, kt, None, v, vs))
    per_row = np.array([5, 100, 300, 12, 1, 7, 2, 99], np.int32)
    for L in (1, 100, 128, 129, 256, 257, 400, 512, per_row):
        tl = _t(L) if isinstance(L, np.ndarray) else L
        got = tda.decode_attention_flat(*targs, tl, length_buckets=True)
        assert torch.equal(got, tda.decode_attention_flat(*targs, tl,
                                                          length_buckets=False))
        _close(got, jda.decode_attention_flat(*jargs, jnp.asarray(L),
                                              length_buckets=False))


def _lowbit_problem(kind, e=6, s=64, dk=16, dv=24, seed=3):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(e, dk)) * 0.3).astype(np.float32)
    kshape = (e, dk, 2, s // 2) if kind == "mixed" else (e, dk, s // 2)
    k = rng.integers(-127 if kind == "mixed" else -128, 128, kshape).astype(np.int8)
    v = rng.integers(-128, 128, (e, s // 2, dv)).astype(np.int8)
    ks = ((rng.random((e, 2, s // 2)) * 0.3 + 0.01)
          / (16 if kind == "mixed" else 1)).astype(np.float32)
    vs = (rng.random((e, 2, s // 2)) * 0.3 + 0.01).astype(np.float32)
    return q, k, ks, v, vs, np.array([0, 1, 2, 7, 63, 64], np.int32)


@pytest.mark.parametrize("kind", ["int4", "mixed"])
def test_direct_lowbit_entries_match_pallas(kind):
    """JAX's direct Pallas K8 entries, a zero-length row giving 0 there and
    here (the dispatchers attend uniformly, as JAX's XLA forms)."""
    jargs, targs = _both(_lowbit_problem(kind))
    entry = {"int4": "decode_attention_int4_blockdiag",
             "mixed": "decode_attention_mixed_blockdiag"}[kind]
    want = getattr(jda, entry)(*jargs, rows_per_program=2)
    got = getattr(tda, entry)(*targs, rows_per_program=2)
    assert got[0].abs().max().item() == 0.0
    _close(got, want)
    disp = tda.decode_attention_int4 if kind == "int4" else tda.decode_attention_mixed
    _close(got[1:], disp(*targs)[1:])


@pytest.mark.parametrize("quant", [False, True])
def test_cache_layout_decode_attention_matches_jax(quant):
    """attention.decode_attention / decode_attention_quant over (b, S, h, dh)
    caches, per-row lengths with an empty row (the -10000 mask: uniform)."""
    rng = np.random.default_rng(5)
    b, S, h, dh = 3, 40, 4, 16
    q = rng.normal(size=(b, 1, h, dh)).astype(np.float32)
    lens = np.array([0, 17, 40], np.int32)
    if quant:
        k = rng.integers(-127, 128, (b, S, h, dh)).astype(np.int8)
        v = rng.integers(-127, 128, (b, S, h, dh)).astype(np.int8)
        kscale = rng.uniform(0.01, 0.05, (b, S, h, 1)).astype(np.float32)
        vscale = rng.uniform(0.01, 0.05, (b, S, h, 1)).astype(np.float32)
        jargs, targs = _both((q, k, kscale, v, vscale, lens))
        want = jattn.decode_attention_quant(*jargs)
        got = tattn.decode_attention_quant(*targs)
    else:
        k = rng.normal(size=(b, S, h, dh)).astype(np.float32)
        v = rng.normal(size=(b, S, h, dh)).astype(np.float32)
        jargs, targs = _both((q, k, v, lens))
        want = jattn.decode_attention(*jargs, softmax_scale=0.3)
        got = tattn.decode_attention(*targs, softmax_scale=0.3)
        _close(tattn.decode_attention(*targs[:3], 9),
               jattn.decode_attention(*jargs[:3], jnp.asarray(9)))
    assert got.shape == (b, 1, h, dh)
    _close(got, want)


def test_mha_qkv_packed_matches_jax_with_gradients():
    """gpt2_test()'s widths (4 heads of 16): forward and the qkv gradient
    of the port's packed entry against JAX's (its Pallas flash forward and
    backward in interpret mode)."""
    cfg = gpt2_test()
    h, dh = cfg.n_head, cfg.n_embd // cfg.n_head
    rng = np.random.default_rng(13)
    qkv = rng.normal(size=(2, 24, 3, h, dh)).astype(np.float32)
    g = rng.normal(size=(2, 24, h, dh)).astype(np.float32)
    jq = jnp.asarray(qkv)
    want = jattn.mha_qkv_packed(jq)
    jgrad = jax.grad(lambda x: jnp.sum(jattn.mha_qkv_packed(x) * jnp.asarray(g)))(jq)
    tq = _t(qkv).requires_grad_()
    got = tattn.mha_qkv_packed(tq)
    (got * _t(g)).sum().backward()
    _close(got.detach(), want)
    _close(tq.grad, jgrad)


def test_flash_attention_with_lse_matches_jax():
    rng = np.random.default_rng(17)
    q, k, v = (rng.normal(size=(2, 40, 3, 16)).astype(np.float32) for _ in range(3))
    lens = np.array([40, 23], np.int32)
    jout, jlse = jfa.flash_attention_with_lse(*(jnp.asarray(a) for a in (q, k, v)),
                                              seq_lengths=jnp.asarray(lens))
    tout, tlse = tfa.flash_attention_with_lse(_t(q), _t(k), _t(v), seq_lengths=_t(lens))
    assert tlse.shape == (2, 3, 40)
    _close(tout, jout)
    _close(tlse, jlse)
