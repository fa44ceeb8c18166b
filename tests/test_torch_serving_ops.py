"""The port's staged decode ops, K8-ml's and K1-ml's plain versions and the
per-row cache writes against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages as f32
(int8 where the caches are int8). Tolerances: the staged attention ops
agree to 1e-5 relative (the same f32 arithmetic in another summation
order); K8-ml's plain version against JAX's Pallas body in interpret mode
to rtol 1e-4 on out, m and l (the interpret body computes in f32 too);
the per-row writes are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu.models import gpt as jgpt
from backpacks_flash_attn_tpu.ops import decode_attention as jda
from backpacks_flash_attn_tpu_torch.models import gpt as tgpt
from backpacks_flash_attn_tpu_torch.ops import decode_attention as tda

torch.set_num_threads(1)

RTOL = 1e-5


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _close(t, j, rtol=RTOL):
    j = np.asarray(j, np.float64)
    t = t.double().numpy()
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * max(np.abs(j).max(), 1))


def _staged_inputs(seed, quant, E=6, dk=8, dv=12, W=16, C=8, t=1):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(E, t, dk) if t > 1 else (E, dk)).astype(np.float32)
    if quant:
        kt = rng.integers(-127, 128, (E, dk, W)).astype(np.int8)
        v = rng.integers(-127, 128, (E, W, dv)).astype(np.int8)
        k_st = rng.integers(-127, 128, (E, C, dk)).astype(np.int8)
        v_st = rng.integers(-127, 128, (E, C, dv)).astype(np.int8)
        ks, vs, ks_st, vs_st = (rng.uniform(0.001, 0.02, sh).astype(np.float32)
                                for sh in ((E, W), (E, W), (E, C), (E, C)))
    else:
        kt, v = (rng.normal(size=sh).astype(np.float32)
                 for sh in ((E, dk, W), (E, W, dv)))
        k_st, v_st = (rng.normal(size=sh).astype(np.float32)
                      for sh in ((E, C, dk), (E, C, dv)))
        ks = vs = ks_st = vs_st = None
    # ragged: row 0 has an empty main segment (base 0), row 1 an empty
    # stage (all free), the last a rolled-back entry (pos >= length)
    base = np.array([0, 5, 9, 3, 12, 7], np.int32)[:E]
    n_st = np.array([3, 0, 2, 4, 1, 3], np.int32)[:E]
    st_pos = np.full((E, C), -1, np.int32)
    for r in range(E):
        st_pos[r, C - n_st[r]:] = base[r] + np.arange(n_st[r])
    length = base + n_st
    st_pos[-1, -1] = length[-1] + 2
    return q, kt, ks, v, vs, base, k_st, ks_st, v_st, vs_st, st_pos, length


@pytest.mark.parametrize("quant", [False, True])
def test_staged_decode_ops_match_jax(quant):
    args = _staged_inputs(0, quant)
    jout = jda.decode_attention_flat_staged(*map(_j, args))
    _close(tda.decode_attention_flat_staged(*map(_t, args)), jout)
    # the port's route: K1's (m, l) form (plain here) + stage + merge
    _close(tda.decode_attention_staged(*map(_t, args)), jout)
    q, _, _, _, _, _, k_st, ks_st, v_st, vs_st, st_pos, length = args
    seg = (q, k_st, ks_st, v_st, vs_st, st_pos, length)
    for t, j in zip(tda.stage_segment_attention(*map(_t, seg)),
                    jda.stage_segment_attention(*map(_j, seg))):
        _close(t, j)
    o, m, l = tda.stage_segment_attention(*map(_t, seg))
    assert (o[1] == 0).all() and m[1, 0] == tda.NEG and l[1, 0] == 0
    margs = _staged_inputs(1, quant, t=3)
    _close(tda.decode_attention_flat_multi_staged(*map(_t, margs)),
           jda.decode_attention_flat_multi_staged(*map(_j, margs)))


def test_merge_softmax_segments_matches_jax():
    rng = np.random.default_rng(2)
    o1, o2 = rng.normal(size=(2, 5, 4)).astype(np.float32)
    m1, m2 = rng.normal(size=(2, 5, 1)).astype(np.float32)
    l1, l2 = rng.uniform(0.5, 3, (2, 5, 1)).astype(np.float32)
    # row 3: one empty segment; row 4: both empty (a slot just admitted)
    m1[3:], l1[3:] = tda.NEG, 0.0
    m2[4], l2[4] = tda.NEG, 0.0
    args = (o1, m1, l1, o2, m2, l2)
    out = tda.merge_softmax_segments(*map(_t, args))
    _close(out, jda.merge_softmax_segments(*map(_j, args)))
    assert (out[4] == 0).all()


def test_k1_ml_plain_form():
    """decode_attention_ml_ref: out as decode_attention_ref on rows with a
    valid position; m, l the row's max score and sum exp(s - m) (those of
    JAX's reference scores); an empty row (0, NEG, 0)."""
    rng = np.random.default_rng(3)
    E, dk, S, dv = 5, 8, 12, 16
    q = rng.normal(size=(E, dk)).astype(np.float32)
    kt = rng.integers(-127, 128, (E, dk, S)).astype(np.int8)
    v = rng.integers(-127, 128, (E, S, dv)).astype(np.int8)
    ks, vs = rng.uniform(0.001, 0.02, (2, E, S)).astype(np.float32)
    lens = np.array([0, 1, 7, 12, 5], np.int32)
    args = (q, kt, ks, v, vs, lens)
    o, m, l = tda.decode_attention_ml_ref(*map(_t, args))
    _close(o[1:], jda.decode_attention_ref(*map(_j, args))[1:])
    s = (q[:, :, None] * kt.astype(np.float64)).sum(1) * ks
    for r in range(1, E):
        sr = s[r, :lens[r]]
        np.testing.assert_allclose(m[r, 0].item(), sr.max(), rtol=1e-5)
        np.testing.assert_allclose(l[r, 0].item(), np.exp(sr - sr.max()).sum(),
                                   rtol=1e-5)
    assert (o[0] == 0).all() and m[0, 0] == tda.NEG and l[0, 0] == 0


def test_k8_ml_plain_matches_jax_pallas_interpret():
    """The Pallas K8-ml body (_stacked_int4_ml_kernel through
    _stacked_call(return_ml=True), interpret mode on the CPU) against the
    port's plain decode_attention_int4_staged_ml: out, m and l of layer 1
    of a stacked packed cache, under a window, over ragged base lengths
    with an odd one and an empty one."""
    rng = np.random.default_rng(4)
    L, E, dk, dv, S2 = 2, 16, 8, 16, 16
    q = rng.normal(size=(E, dk)).astype(np.float32)
    k_all = rng.integers(-128, 128, (L, E, dk, S2)).astype(np.int8)
    v_all = rng.integers(-128, 128, (L, E, S2, dv)).astype(np.int8)
    ks_all, vs_all = rng.uniform(0.01, 0.1, (2, L, E, 2, S2)).astype(np.float32)
    base = rng.integers(1, 2 * S2 + 1, (E,)).astype(np.int32)
    base[0], base[1], base[2] = 0, 7, 2 * S2
    jout = jda._stacked_call(
        jda._stacked_int4_ml_kernel, 1, jnp.asarray(q), jnp.asarray(k_all),
        jnp.asarray(ks_all), jnp.asarray(v_all), jnp.asarray(vs_all),
        jnp.asarray(base), window_cols=None, k_block_extra=(),
        return_ml=True)[:3]
    tout = tda.decode_attention_int4_staged_ml(
        1, _t(q), _t(k_all), _t(ks_all), _t(v_all), _t(vs_all), _t(base))
    for name, t, j in zip(("out", "m", "l"), tout, jout):
        _close(t, j, rtol=1e-4)
    assert (tout[0][0] == 0).all() and tout[1][0, 0] == tda.NEG
    # under a window: only the first 8 packed columns, lengths within it
    wbase = np.minimum(base, 16)
    jw = jda._stacked_call(
        jda._stacked_int4_ml_kernel, 0, jnp.asarray(q), jnp.asarray(k_all),
        jnp.asarray(ks_all), jnp.asarray(v_all), jnp.asarray(vs_all),
        jnp.asarray(wbase), window_cols=8, k_block_extra=(),
        return_ml=True)[:3]
    tw = tda.decode_attention_int4_staged_ml(
        0, _t(q), _t(k_all), _t(ks_all), _t(v_all), _t(vs_all), _t(wbase),
        window_cols=8)
    for t, j in zip(tw, jw):
        _close(t, j, rtol=1e-4)


# ------------------------------------------------------------ per-row writes

def _offsets(rng, E, hi):
    off = rng.integers(0, hi, (E,)).astype(np.int32)
    off[0] = hi + 3          # a row past the bound: its write is dropped
    return off


@pytest.mark.parametrize("s", [1, 3])
def test_row_writes_bit_equal_jax(s):
    rng = np.random.default_rng(5 + s)
    E, d, S, W = 6, 5, 16, 10
    for axis, shape, nshape in ((1, (E, S, d), (E, s, d)),
                                (2, (E, d, S), (E, d, s)),
                                (1, (E, S), (E, s))):
        buf = rng.integers(-127, 128, shape).astype(np.int8)
        new = rng.integers(-127, 128, nshape).astype(np.int8)
        for window in (None, W):
            off = _offsets(rng, E, (window or S) - s + 2)
            tb = torch.from_numpy(buf.copy())
            tgpt.update_rows_axis_windowed(tb, _t(new), _t(off), axis, window)
            jb = jgpt.update_rows_axis_windowed(_j(buf), _j(new), _j(off),
                                                axis, window)
            np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    # a scalar offset writes the block
    tb = torch.from_numpy(buf.copy())
    tgpt.update_rows_axis(tb, _t(new), 4, 1)
    np.testing.assert_array_equal(
        tb.numpy(), np.asarray(jgpt.update_rows_axis(_j(buf), _j(new), 4, 1)))


def test_lowbit_row_writes_bit_equal_jax():
    rng = np.random.default_rng(9)
    E, d, S2, window = 6, 4, 8, 10
    for axis, shape, nshape in ((1, (E, S2, d), (E, 1, d)),
                                (2, (E, d, S2), (E, d, 1))):
        buf = rng.integers(-128, 128, shape).astype(np.int8)
        nib = rng.integers(-7, 8, nshape).astype(np.int8)
        for w in (None, window):
            off = _offsets(rng, E, (w or 2 * S2) - 1)
            tb = torch.from_numpy(buf.copy())
            tgpt.rmw_nibble_axis_windowed(tb, _t(nib), _t(off), axis, w)
            jb = jgpt.rmw_nibble_axis_windowed(_j(buf), _j(nib), _j(off),
                                               axis, w)
            np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    split = rng.integers(-128, 128, (E, d, 2, S2)).astype(np.int8)
    val = rng.integers(-127, 128, (E, d, 1)).astype(np.int8)
    scale = rng.uniform(0.1, 1, (E, 2, S2)).astype(np.float32)
    sval = rng.uniform(0.1, 1, (E,)).astype(np.float32)
    for w in (None, window):
        off = _offsets(rng, E, (w or 2 * S2) - 1)
        tb = torch.from_numpy(split.copy())
        tgpt.store_split8_step(tb, _t(val), _t(off), w)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(
            jgpt.store_split8_step(_j(split), _j(val), _j(off), w)))
        tsc = torch.from_numpy(scale.copy())
        tgpt.update_pair_scale(tsc, _t(sval), _t(off), w)
        np.testing.assert_array_equal(tsc.numpy(), np.asarray(
            jgpt.update_pair_scale(_j(scale), _j(sval), _j(off), w)))
