"""The port's per-slot and staged serving caches against the JAX package's,
on the CPU.

``backpack_test()`` weights (2 layers, d = 64, nv = 4, vocab 512) cross
over through ``params_from_numpy``; token ids come from numpy seeds. The
cases of the JAX package's tests/models/test_staged_cache.py,
test_serving_cache.py and the staged tests of tests/ops/test_decode_int4.py
run here on both packages: per-slot prefill and ragged decode, staged
decode across a flush, a speculative-style multi-token step and its
rollback, admission into a staged cache, the staged int4 GPT decode with
its packed flush, and flush/insert/extract themselves.

Tolerances (f32 weights and activations; the caches f32, INT8 or int4).
f32 caches: logits within 1e-4 of the largest logit (the same f32
arithmetic, summed in other orders). INT8 and int4 caches: 1e-3 of the
largest logit, and cache contents within one quantization step, because
XLA's and torch's activations differ in their last bits and a value on a
rounding boundary takes the neighbouring code in one package (as in
tests/test_torch_lowbit_models.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu import config as jcfg
from backpacks_flash_attn_tpu.models import backpack as jbp
from backpacks_flash_attn_tpu.models import gpt as jgpt
from backpacks_flash_attn_tpu_torch import config as tcfg
from backpacks_flash_attn_tpu_torch.models import backpack as tbp
from backpacks_flash_attn_tpu_torch.models import gpt as tgpt
from backpacks_flash_attn_tpu_torch.ops import quant as tq
from backpacks_flash_attn_tpu_torch.utils.weights import params_from_numpy

torch.set_num_threads(1)

MAX_LEN = 32
TOL = {jnp.float32: 1e-4, jnp.int8: 1e-3}
TDT = {jnp.float32: torch.float32, jnp.int8: torch.int8}


@pytest.fixture(scope="module")
def setup():
    jc, tc = jcfg.backpack_test(), tcfg.backpack_test()
    jparams = jbp.init_backpack(jc, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jc, tc, {dt: (jparams, tparams) for dt in TDT}


def _ids(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _jax_step(cfg, window=None):
    return jax.jit(lambda p, i, c: jbp.backpack_forward_with_cache(
        p, cfg, i, c, window=window))


def _close(tl, jl, tol):
    jl = np.asarray(jl)
    err = np.abs(tl.float().numpy() - jl).max()
    assert err <= tol * np.abs(jl).max(), (err, np.abs(jl).max())


def _step(setup, dtype, ids, jcache, tcache, window=None):
    jc, tc, params = setup
    jp, tp = params[dtype]
    jl, jcache = _jax_step(jc, window)(jp, ids, jcache)
    tl, tcache = tbp.backpack_forward_with_cache(
        tp, tc, torch.from_numpy(np.asarray(ids)).long(), tcache,
        window=window)
    _close(tl, jl, TOL[dtype])
    return np.asarray(jl), jcache, tl, tcache


def _caches(setup, dtype, b, **kw):
    jc, tc, _ = setup
    return (jbp.init_backpack_cache(jc, b, MAX_LEN, dtype=dtype, **kw),
            tbp.init_backpack_cache(tc, b, MAX_LEN, TDT[dtype], device="cpu",
                                    **kw))


def _np(x):
    x = x.float() if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16 else x
    return np.asarray(x)


def _main_close(tcache, jcache, n, dtype):
    """The main caches' first n positions: equal (f32), or within one
    quantization step (int8, compared dequantized)."""
    pairs = [(tcache.gpt.k, tcache.gpt.k_scale, jcache.gpt.k,
              jcache.gpt.k_scale, -1),
             (tcache.gpt.v, tcache.gpt.v_scale, jcache.gpt.v,
              jcache.gpt.v_scale, -2),
             (tcache.ctx_k, tcache.ctx_k_scale, jcache.ctx_k,
              jcache.ctx_k_scale, -1),
             (tcache.content, tcache.content_scale, jcache.content,
              jcache.content_scale, -2)]
    for tv, ts, jv, js, axis in pairs:
        tv, jv = _np(tv).astype(np.float64), _np(jv).astype(np.float64)
        sl = [slice(None)] * tv.ndim
        sl[axis] = slice(0, n)
        sl = tuple(sl)
        if ts is None:
            np.testing.assert_allclose(tv[sl], jv[sl], rtol=1e-5, atol=1e-5)
            continue
        ts, js = _np(ts).astype(np.float64), _np(js).astype(np.float64)
        if axis == -1:
            ts, js = ts[..., None, :], js[..., None, :]
        else:
            ts, js = ts[..., None], js[..., None]
        err = np.abs(tv * ts - jv * js)[sl]
        step = np.broadcast_to(np.maximum(ts, js), tv.shape)[sl]
        assert (err <= step * 1.0001 + 1e-9).all(), err.max()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.int8])
def test_staged_decode_across_a_flush_matches_jax(setup, dtype):
    """Per-slot prefill of a staged cache (s = 5 > C would not stage; 5 <=
    8 stages into a C = 8 block), six staged decode steps with a flush
    after the second, then a final flush: logits against JAX's staged
    cache and against the port's own unstaged per-slot cache, and the
    flushed main cache against JAX's."""
    b, C = 2, 8
    ids = _ids(1, b, 5)
    jst, tst = _caches(setup, dtype, b, per_slot=True, stage=C)
    jref, tref = _caches(setup, dtype, b, per_slot=True)
    jl, jst, _, tst = _step(setup, dtype, ids, jst, tst)
    _, jref, _, tref = _step(setup, dtype, ids, jref, tref)
    tok = jl[:, -1:].argmax(-1).astype(np.int32)
    for step in range(6):
        jl, jst, tl, tst = _step(setup, dtype, tok, jst, tst, window=16)
        _, jref, tlr, tref = _step(setup, dtype, tok, jref, tref, window=16)
        _close(tl, np.asarray(tlr.numpy()), TOL[dtype])
        if step == 1:
            jst = jbp.flush_cache(jst)
            tbp.flush_cache(tst)
            assert tst.gpt.stage_ptr == 0 and (tst.gpt.stage_pos == -1).all()
            assert torch.equal(tst.gpt.base_len, tst.length)
        tok = jl[:, -1:].argmax(-1).astype(np.int32)
    assert tst.gpt.stage_ptr == int(jst.gpt.stage_ptr) == 4
    np.testing.assert_array_equal(tst.gpt.stage_pos.numpy(),
                                  np.asarray(jst.gpt.stage_pos))
    jst = jbp.flush_cache(jst, window=16)
    tbp.flush_cache(tst, window=16)
    n = int(np.asarray(jst.length)[0])
    _main_close(tst, jst, n, dtype)
    _main_close(tst, tref, n, dtype)


def test_staged_multi_query_and_rollback_matches_jax(setup):
    """A (1+k)-token staged step (the speculative verification shape),
    then the lengths roll back to one accepted token: the rolled-back
    staged entries are masked and the next step overwrites them."""
    dtype, b, k = jnp.float32, 2, 2
    jst, tst = _caches(setup, dtype, b, per_slot=True, stage=8)
    _, jst, _, tst = _step(setup, dtype, _ids(2, b, 4), jst, tst)
    _, jst, _, tst = _step(setup, dtype, _ids(3, b, 1 + k), jst, tst)
    roll = jst.length - k
    jst = jst._replace(length=roll, gpt=jst.gpt._replace(length=roll))
    tst.length = tst.length - k
    tst.gpt.length = tst.gpt.length - k
    _, jst, _, tst = _step(setup, dtype, _ids(4, b, 1), jst, tst)
    np.testing.assert_array_equal(tst.gpt.stage_pos.numpy(),
                                  np.asarray(jst.gpt.stage_pos))


def test_staged_insert_slot_invalidates_matches_jax(setup):
    """Admission into a staged cache: the fresh slot's staged entries are
    dropped and its flushed horizon is the prefill length; the other slot
    keeps its staged entries; both keep decoding as in JAX."""
    dtype, b = jnp.float32, 2
    jst, tst = _caches(setup, dtype, b, per_slot=True, stage=8)
    jl, jst, _, tst = _step(setup, dtype, _ids(5, b, 4), jst, tst)
    tok = jl[:, -1:].argmax(-1).astype(np.int32)
    _, jst, _, tst = _step(setup, dtype, tok, jst, tst)
    jsm, tsm = _caches(setup, dtype, 1, per_slot=True)
    pl, jsm, _, tsm = _step(setup, dtype, _ids(6, 1, 3), jsm, tsm)
    jst = jbp.insert_cache_slot(jst, jsm, 1)
    tbp.insert_cache_slot(tst, tsm, 1)
    assert tst.gpt.base_len.tolist() == np.asarray(jst.gpt.base_len).tolist()
    assert tst.gpt.base_len[1] == 3 and (tst.gpt.stage_pos[1] == -1).all()
    np.testing.assert_array_equal(tst.gpt.stage_pos.numpy(),
                                  np.asarray(jst.gpt.stage_pos))
    nxt = np.concatenate([tok[:1], pl[:, -1:].argmax(-1)], 0).astype(np.int32)
    for _ in range(3):
        jl, jst, _, tst = _step(setup, dtype, nxt, jst, tst)
        nxt = jl[:, -1:].argmax(-1).astype(np.int32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.int8])
def test_ragged_slots_match_jax_and_independent_decode(setup, dtype):
    """Each prompt prefilled alone (scalar length), inserted into a
    per-slot cache; ragged decode against JAX's per-slot cache, and the
    port's rows against its own independent batch-1 decodes."""
    prompts = [_ids(7 + i, 1, n) for i, n in enumerate((3, 7, 5))]
    jbig, tbig = _caches(setup, dtype, 3, per_slot=True)
    first, singles = [], []
    for i, p in enumerate(prompts):
        jsm, tsm = _caches(setup, dtype, 1)
        jl, jsm, _, tsm = _step(setup, dtype, p, jsm, tsm)
        jbig = jbp.insert_cache_slot(jbig, jsm, i)
        tbp.insert_cache_slot(tbig, tsm, i)
        first.append(jl[0, -1].argmax())
        singles.append(tsm)
    toks = np.asarray(first, np.int32)[:, None]
    for _ in range(3):
        jl, jbig, tl, tbig = _step(setup, dtype, toks, jbig, tbig)
        for i, tsm in enumerate(singles):
            tl1, singles[i] = tbp.backpack_forward_with_cache(
                setup[2][dtype][1], setup[1],
                torch.from_numpy(toks[i:i + 1]).long(), tsm)
            _close(tl[i:i + 1], tl1.numpy(), TOL[dtype])
        toks = jl[:, -1:].argmax(-1).astype(np.int32)
    assert tbig.length.tolist() == [len(p[0]) + 3 for p in prompts]


def test_extract_and_insert_match_jax(setup):
    """extract_cache_slot then insert_cache_slot move one row's state
    between per-slot caches exactly as in JAX."""
    dtype = jnp.int8
    jsrc, tsrc = _caches(setup, dtype, 3, per_slot=True)
    _, jsrc, _, tsrc = _step(setup, dtype, _ids(11, 3, 6), jsrc, tsrc)
    jdst, tdst = _caches(setup, dtype, 2, per_slot=True, stage=4)
    jrow = jbp.extract_cache_slot(jsrc, 2, setup[0])
    trow = tbp.extract_cache_slot(tsrc, 2, setup[1])
    assert int(jrow.length) == int(trow.length) == 6
    jdst = jbp.insert_cache_slot(jdst, jrow, 0)
    tbp.insert_cache_slot(tdst, trow, 0)
    assert tdst.length.tolist() == np.asarray(jdst.length).tolist() == [6, 0]
    assert tdst.gpt.base_len.tolist() == [6, 0]
    _main_close(tdst, jdst, 6, dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.int8])
def test_sense_weights_match_jax(setup, dtype):
    """Per-request (b, nv) sense weights through a per-slot prefill and
    decode steps (folded into the value scales, and into alpha in the
    prefill)."""
    jc, tc, params = setup
    jp, tp = params[dtype]
    w = np.random.default_rng(12).uniform(0.2, 4.0, (2, 4)).astype(np.float32)
    jcache, tcache = _caches(setup, dtype, 2, per_slot=True)
    ids = _ids(13, 2, 12)
    for start, stop in ((0, 10), (10, 11), (11, 12)):
        jl, jcache = jbp.backpack_forward_with_cache(
            jp, jc, jnp.asarray(ids[:, start:stop]), jcache,
            sense_weights=jnp.asarray(w))
        tl, tcache = tbp.backpack_forward_with_cache(
            tp, tc, torch.from_numpy(ids[:, start:stop]).long(), tcache,
            sense_weights=torch.from_numpy(w))
        _close(tl, jl, TOL[dtype])


def test_mixed_cache_sense_weights_match_jax(setup):
    """The mixed low-bit cache folds the weights into its parity-layout
    value scales on a decode step."""
    jc, tc, params = setup
    jp, tp = params[jnp.int8]
    w = np.random.default_rng(14).uniform(0.2, 4.0, (4,)).astype(np.float32)
    jcache = jbp.init_backpack_cache(jc, 2, MAX_LEN, dtype=jnp.int8, bits=4)
    tcache = tbp.init_backpack_cache(tc, 2, MAX_LEN, torch.int8, device="cpu",
                                     bits=4)
    ids = _ids(15, 2, 10)
    for start, stop in ((0, 8), (8, 9), (9, 10)):
        jl, jcache = jbp.backpack_forward_with_cache(
            jp, jc, jnp.asarray(ids[:, start:stop]), jcache,
            sense_weights=jnp.asarray(w))
        tl, tcache = tbp.backpack_forward_with_cache(
            tp, tc, torch.from_numpy(ids[:, start:stop]).long(), tcache,
            sense_weights=torch.from_numpy(w))
        _close(tl, jl, 1e-3)


# ------------------------------------------------------------ staged int4 GPT

@pytest.fixture(scope="module")
def gpt_setup():
    jc, tc = jcfg.gpt2_test(), tcfg.gpt2_test()
    jparams = jgpt.init_gpt(jc, jax.random.PRNGKey(0))
    return jc, tc, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _deq4(packed, sc2, axis):
    vals = tq.unpack_int4_pairs(torch.from_numpy(np.array(packed)), axis)
    sc = tq.interleave_pair_scales(torch.from_numpy(np.array(sc2)))
    sc = sc[..., None, :] if axis == vals.dim() - 1 else sc[..., None]
    return (vals.double() * sc.double()).numpy(), np.broadcast_to(
        sc.double().numpy(), vals.shape)


def test_staged_int4_gpt_decode_and_packed_flush_match_jax(gpt_setup):
    """Staged decode over a packed int4 GPT cache (K8-ml's plain version
    over the main segment + the int8 stage segment, merged), flushed every
    6 steps into the packed cache, against JAX (test_decode_int4.py:219):
    hidden states within 1e-3 of the largest, and the flushed cache within
    one int4 step of JAX's."""
    jc, tc, jp, tp = gpt_setup
    ids = _ids(16, 2, 20)
    jstep = jax.jit(lambda c, i: jgpt.gpt_forward_with_cache(jp, jc, i, c))
    jcs = jgpt.init_kv_cache(jc, 2, MAX_LEN, jnp.int8, bits=4, per_slot=True,
                             stage=8)
    tcs = tgpt.init_kv_cache(tc, 2, MAX_LEN, torch.int8, device="cpu",
                             bits=4, per_slot=True, stage=8)
    j0 = jgpt.init_kv_cache(jc, 2, MAX_LEN, jnp.int8, bits=4)
    t0 = tgpt.init_kv_cache(tc, 2, MAX_LEN, torch.int8, device="cpu", bits=4)
    _, j0 = jgpt.gpt_forward_with_cache(jp, jc, jnp.asarray(ids[:, :8]), j0)
    _, t0 = tgpt.gpt_forward_with_cache(tp, tc, torch.from_numpy(
        ids[:, :8]).long(), t0)
    eight = jnp.full((2,), 8, jnp.int32)
    jcs = jcs._replace(k=j0.k, v=j0.v, k_scale=j0.k_scale, v_scale=j0.v_scale,
                       length=eight, base_len=eight)
    for name in ("k", "v", "k_scale", "v_scale"):
        getattr(tcs, name).copy_(getattr(t0, name))
    tcs.length = torch.full((2,), 8, dtype=torch.int32)
    tcs.base_len.fill_(8)
    for n, t in enumerate(range(8, 20)):
        jh, jcs = jstep(jcs, jnp.asarray(ids[:, t:t + 1]))
        th, tcs = tgpt.gpt_forward_with_cache(
            tp, tc, torch.from_numpy(ids[:, t:t + 1]).long(), tcs)
        _close(th, jh, 1e-3)
        if (n + 1) % 6 == 0:
            jcs = jgpt.flush_kv_cache(jcs)
            tgpt.flush_kv_cache(tcs)
            assert tcs.base_len.tolist() == [t + 1] * 2
    for tbuf, tsc, jbuf, jsc, axis in ((tcs.k, tcs.k_scale, jcs.k, jcs.k_scale, 3),
                                       (tcs.v, tcs.v_scale, jcs.v, jcs.v_scale, 2)):
        tv, ts = _deq4(tbuf, tsc, axis)
        jv, js = _deq4(jbuf, jsc, axis)
        sl = [slice(None)] * tv.ndim
        sl[axis] = slice(0, 20)
        sl = tuple(sl)
        err = np.abs(tv - jv)[sl]
        assert (err <= np.maximum(ts, js)[sl] * 1.0001 + 1e-9).all(), err.max()


def test_packed_flush_places_staged_values(gpt_setup):
    """flush_kv_cache on a packed cache writes each staged int8 column at
    its logical position, re-quantized to int4 exactly as JAX does (the
    staged values cross over unchanged, so the packed bytes and scales are
    bit-equal), and resets the stage (test_decode_int4.py:261)."""
    jc, tc, _, _ = gpt_setup
    rng = np.random.default_rng(17)
    jcs = jgpt.init_kv_cache(jc, 2, MAX_LEN, jnp.int8, bits=4, per_slot=True,
                             stage=8)
    tcs = tgpt.init_kv_cache(tc, 2, MAX_LEN, torch.int8, device="cpu",
                             bits=4, per_slot=True, stage=8)
    L, e, C, dk = tcs.k_stage.shape
    fields = dict(
        k_stage=rng.integers(-127, 128, (L, e, C, dk)).astype(np.int8),
        v_stage=rng.integers(-127, 128, (L, e, C, dk)).astype(np.int8),
        ks_stage=rng.uniform(0.01, 0.1, (L, e, C)).astype(np.float32),
        vs_stage=rng.uniform(0.01, 0.1, (L, e, C)).astype(np.float32),
        stage_pos=np.array([[4, 5, 6, 7, 9, -1, 8, -1],
                            [3, 2, 12, 4, -1, -1, -1, 5]], np.int32))
    length = np.array([9, 5], np.int32)
    jcs = jcs._replace(**{k: jnp.asarray(v) for k, v in fields.items()},
                       stage_ptr=jnp.asarray(8, jnp.int32),
                       length=jnp.asarray(length))
    for k, v in fields.items():
        getattr(tcs, k).copy_(torch.from_numpy(v))
    tcs.stage_ptr, tcs.length = 8, torch.from_numpy(length)
    jout = jgpt.flush_kv_cache(jcs, window=16)
    tgpt.flush_kv_cache(tcs, window=16)
    for name in ("k", "v", "k_scale", "v_scale", "stage_pos", "base_len"):
        np.testing.assert_array_equal(getattr(tcs, name).numpy(),
                                      np.asarray(getattr(jout, name)), name)
    assert tcs.stage_ptr == int(jout.stage_ptr) == 0
