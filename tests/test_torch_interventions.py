"""The port's Backpack interventions against the JAX package's, on the CPU.

``backpack_test()`` weights (2 layers, d 64, nv 4, vocab 512) cross over
through ``params_from_numpy``; the same tables and tokens, made from a seed
with numpy, go through ``models/interventions.py`` in both packages at f32.
Logits are held to ``atol=1e-4, rtol=0`` (tests/test_torch_models.py). The
JAX side runs as its own tests run it (Pallas in interpret mode on the
CPU), its calls jitted so each shape compiles once; the weights and the
INT8 tree stay eager JAX (jitted, their last bits move, and they are the
tests' inputs).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu import config as jcfg
from backpacks_flash_attn_tpu.models import backpack as jbp
from backpacks_flash_attn_tpu.models import interventions as jiv
from backpacks_flash_attn_tpu.models import quantized as jqz
from backpacks_flash_attn_tpu_torch import config as tcfg
from backpacks_flash_attn_tpu_torch.models import backpack as tbp
from backpacks_flash_attn_tpu_torch.models import interventions as tiv
from backpacks_flash_attn_tpu_torch.utils.weights import params_from_numpy

torch.set_num_threads(1)

ATOL = 1e-4
MAX_LEN = 32
QUANTILE = 0.05          # 26 of the 512 padded vocabulary entries


@pytest.fixture(scope="module")
def setup():
    jc, tc = jcfg.backpack_test(), tcfg.backpack_test()
    jparams = jbp.init_backpack(jc, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jc, tc, jparams, tparams


def _ids(seed, b, s):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(np.int32)


def _table(seed, lo=0.4, span=1.2):
    """A strictly positive (V, nv) table (the negative decode's condition)."""
    r = np.random.default_rng(seed).uniform(size=(512, 4)).astype(np.float32)
    return (lo + span * r).astype(np.float32)


def _close(t, j, err_msg="", atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0,
                               err_msg=err_msg)


@functools.lru_cache(maxsize=None)
def _jax_weighted(cfg, anneal):
    return jax.jit(lambda p, i, c, s, t: jiv.weighted_decode_step(
        p, cfg, i, c, s, t, anneal=anneal, annealing_scale=0.2))


@functools.lru_cache(maxsize=None)
def _jax_negative(cfg, anneal, masked=False, window=None):
    def step(p, i, c, s, t, mask, w, tm):
        return jiv.negative_decode_step(
            p, cfg, i, c, s, t, anneal=anneal, annealing_scale=0.2,
            quantile=QUANTILE, negative_mask=mask if masked else None,
            sense_weights=w if masked else None,
            token_mask=tm if masked else None, window=window)
    return jax.jit(step)


def _greedy(logits):
    return np.asarray(logits)[:, -1].argmax(-1)[:, None].astype(np.int32)


def _jit_call(fn, *args, **kw):
    """fn(*args, **kw) as one jitted executable."""
    return jax.jit(lambda: fn(*args, **kw))()


@functools.lru_cache(maxsize=None)
def _jax_init(fn, *args, **kw):
    """A JAX cache or decode state of zeros, one executable a shape (the
    arrays are immutable, so the tests share them)."""
    return _jit_call(fn, *args, **kw)


@pytest.mark.parametrize("anneal", [False, True])
def test_weighted_decode_step_matches_jax(setup, anneal):
    """Prefill + 5 greedy decode steps: logits, the annealing sums and the
    weights' inputs equal JAX's, step by step."""
    jc, tc, jp, tp = setup
    table = _table(3, lo=1.0, span=0.5)
    ids = _ids(4, 2, 5)
    jcache = _jax_init(jbp.init_backpack_cache, jc, 2, MAX_LEN, dtype=jnp.float32)
    jstate = _jax_init(jiv.init_weighted_decode_state, jc, 2, MAX_LEN)
    tcache = tbp.init_backpack_cache(tc, 2, MAX_LEN, torch.float32, device="cpu")
    tstate = tiv.init_weighted_decode_state(tc, 2, MAX_LEN, device="cpu")
    tt = torch.from_numpy(table)
    step = _jax_weighted(jc, anneal)
    for i in range(6):
        jl, jcache, jstate = step(jp, ids, jcache, jstate, table)
        tl, tcache, tstate = tiv.weighted_decode_step(
            tp, tc, torch.from_numpy(ids).long(), tcache, tstate, tt,
            anneal=anneal, annealing_scale=0.2)
        _close(tl, jl, f"step {i}")
        _close(tstate.sums, jstate.sums, f"sums {i}", atol=1e-3)
        assert tstate.token_ids.tolist() == np.asarray(jstate.token_ids).tolist()
        ids = _greedy(jl)


@pytest.mark.parametrize("anneal", [False, True])
def test_negative_decode_step_matches_jax(setup, anneal):
    """Prefill + 5 greedy decode steps of the negative-weighted decode:
    logits, the sparse state's values, thresholds and kept index sets."""
    jc, tc, jp, tp = setup
    table = _table(5)
    ids = _ids(6, 2, 5)
    jcache = _jax_init(jbp.init_backpack_cache, jc, 2, MAX_LEN, dtype=jnp.float32)
    jstate = _jax_init(jiv.init_negative_decode_state, jc, 2, MAX_LEN,
                       quantile=QUANTILE)
    tcache = tbp.init_backpack_cache(tc, 2, MAX_LEN, torch.float32, device="cpu")
    tstate = tiv.init_negative_decode_state(tc, 2, MAX_LEN, quantile=QUANTILE,
                                            device="cpu")
    assert tstate.neg_vals.shape == jstate.neg_vals.shape
    tt = torch.from_numpy(table)
    step = _jax_negative(jc, anneal)
    for i in range(6):
        jl, jcache, jstate = step(jp, ids, jcache, jstate, table, None, None,
                                  None)
        tl, tcache, tstate = tiv.negative_decode_step(
            tp, tc, torch.from_numpy(ids).long(), tcache, tstate, tt,
            anneal=anneal, annealing_scale=0.2, quantile=QUANTILE)
        _close(tl, jl, f"step {i}")
        _close(tstate.neg_vals, jstate.neg_vals, f"vals {i}", atol=1e-5)
        _close(tstate.thresh, jstate.thresh, f"thresh {i}", atol=1e-5)
        kept = np.asarray(jstate.neg_vals) < np.asarray(jstate.thresh)[..., None]
        assert (tstate.neg_vals < tstate.thresh[..., None]).numpy().tolist() \
            == kept.tolist()
        jidx = np.where(kept, np.asarray(jstate.neg_idx), -1)
        tidx = np.where(kept, tstate.neg_idx.numpy(), -1)
        assert (np.sort(tidx, -1) == np.sort(jidx, -1)).all()
        ids = _greedy(jl)


def test_negative_decode_step_mask_weights_slot_lengths_match_jax(setup):
    """The engine's form: a per-slot cache prefilled over a right-padded
    bucket (token_mask), lengths cut to [6, 4], then decode steps under a
    window with a negative_mask and per-request sense weights."""
    jc, tc, jp, tp = setup
    table = _table(7)
    ids = _ids(8, 2, 6)
    tm = np.array([[1] * 6, [1] * 4 + [0] * 2], bool)
    sw = np.array([[1.0, 1.5, 0.5, 1.0], [1.2, 1.0, 1.0, 0.7]], np.float32)
    mask = np.array([False, True])
    jcache = _jax_init(jbp.init_backpack_cache, jc, 2, MAX_LEN, dtype=jnp.float32,
                       per_slot=True)
    jstate = _jax_init(jiv.init_negative_decode_state, jc, 2, MAX_LEN,
                       quantile=QUANTILE)
    tcache = tbp.init_backpack_cache(tc, 2, MAX_LEN, torch.float32, device="cpu",
                                     per_slot=True)
    tstate = tiv.init_negative_decode_state(tc, 2, MAX_LEN, quantile=QUANTILE,
                                            device="cpu")
    tt = torch.from_numpy(table)
    pre = _jax_negative(jc, True, masked=True)
    jl, jcache, jstate = pre(jp, ids, jcache, jstate, table, None, None, tm)
    tl, tcache, tstate = tiv.negative_decode_step(
        tp, tc, torch.from_numpy(ids).long(), tcache, tstate, tt, anneal=True,
        annealing_scale=0.2, quantile=QUANTILE, token_mask=torch.from_numpy(tm))
    _close(tl[0], jl[0])
    _close(tl[1, :4], jl[1, :4])
    lens = np.array([6, 4], np.int32)
    jcache = jcache._replace(length=jnp.asarray(lens),
                             gpt=jcache.gpt._replace(length=jnp.asarray(lens)))
    tcache.length = torch.from_numpy(lens)
    tcache.gpt.length = torch.from_numpy(lens.copy())
    jl = np.asarray(jl)
    nxt = np.array([[jl[0, 5].argmax()], [jl[1, 3].argmax()]], np.int32)
    step = _jax_negative(jc, True, masked=True, window=16)
    for i in range(5):
        jl, jcache, jstate = step(jp, nxt, jcache, jstate, table, mask, sw,
                                  None)
        tl, tcache, tstate = tiv.negative_decode_step(
            tp, tc, torch.from_numpy(nxt).long(), tcache, tstate, tt,
            anneal=True, annealing_scale=0.2, quantile=QUANTILE,
            negative_mask=torch.from_numpy(mask),
            sense_weights=torch.from_numpy(sw), window=16)
        _close(tl, jl, f"step {i}")
        nxt = _greedy(jl)
    assert tcache.length.tolist() == [11, 9]


def test_decode_steps_match_full_recompute(setup):
    """The port's incremental decodes against the port's own full
    recomputes (tests/models/test_interventions.py:185-299): greedy
    tokens equal, logits close, both anneal settings."""
    _, tc, _, tp = setup
    ids = torch.from_numpy(_ids(9, 2, 4)).long()
    for anneal in (False, True):
        for mode in ("weighted", "negative"):
            table = torch.from_numpy(_table(10 + anneal))
            full_ids, full_last = ids, []
            for _ in range(4):
                if mode == "weighted":
                    logits = tiv.weighted_forward(tp, tc, full_ids, table,
                                                  anneal=anneal)
                else:
                    logits = tiv.negative_weighted_forward(
                        tp, tc, full_ids, table, anneal=anneal,
                        quantile=QUANTILE, key_chunk=3)
                full_last.append(logits[:, -1])
                full_ids = torch.cat([full_ids,
                                      logits[:, -1].argmax(-1)[:, None]], 1)
            cache = tbp.init_backpack_cache(tc, 2, 16, torch.float32,
                                            device="cpu")
            if mode == "weighted":
                state = tiv.init_weighted_decode_state(tc, 2, 16, torch.float32,
                                                       device="cpu")
                step = functools.partial(tiv.weighted_decode_step, anneal=anneal)
            else:
                state = tiv.init_negative_decode_state(
                    tc, 2, 16, quantile=QUANTILE, device="cpu")
                step = functools.partial(tiv.negative_decode_step,
                                         anneal=anneal, quantile=QUANTILE)
            tok = ids
            for i in range(4):
                logits, cache, state = step(tp, tc, tok, cache, state, table)
                np.testing.assert_allclose(logits[:, -1].numpy(),
                                           full_last[i].numpy(), atol=2e-4,
                                           rtol=0, err_msg=f"{mode} {anneal}")
                tok = logits[:, -1].argmax(-1)[:, None]
                assert tok[:, 0].tolist() == full_ids[:, 4 + i].tolist()


@pytest.mark.parametrize("fused_ctx", [False, True])
def test_backpack_forward_sense_weights_and_edit_match_jax(setup, fused_ctx):
    """backpack_forward(sense_weights=, sense_edit=) on either combine route
    against JAX's (its fused Pallas combine), (b, s, nv) and (nv,) weights;
    the cached forward's sense_edit and return_ctx_q against JAX's."""
    jc, tc, jp, tp = setup
    ids = _ids(11, 2, 12)
    rng = np.random.default_rng(12)
    sw = rng.uniform(0.5, 1.5, (2, 12, 4)).astype(np.float32)
    edit_ids = np.array([ids[0, 3], ids[1, 7], 5], np.int32)
    edit_senses = rng.normal(size=(3, 4, 64)).astype(np.float32) * 0.1
    tids = torch.from_numpy(ids).long()
    for w in (sw, sw[0, 0]):
        jl = jax.jit(lambda p, i, w, e, s: jbp.backpack_forward(
            p, jc, i, sense_weights=w, sense_edit=(e, s)))(
                jp, ids, w, edit_ids, edit_senses)
        tl = tbp.backpack_forward(
            tp, tc, tids, sense_weights=torch.from_numpy(w),
            sense_edit=(torch.from_numpy(edit_ids), torch.from_numpy(edit_senses)),
            fused_ctx=fused_ctx)
        _close(tl, jl, f"weights {w.shape}")
    if not fused_ctx:
        return
    jcache = _jax_init(jbp.init_backpack_cache, jc, 2, MAX_LEN, dtype=jnp.float32)
    tcache = tbp.init_backpack_cache(tc, 2, MAX_LEN, torch.float32, device="cpu")
    jl, _, jq = jax.jit(lambda p, i, c, e, s: jbp.backpack_forward_with_cache(
        p, jc, i, c, sense_edit=(e, s), return_ctx_q=True))(
            jp, ids, jcache, edit_ids, edit_senses)
    tl, _, tq = tbp.backpack_forward_with_cache(
        tp, tc, tids, tcache,
        sense_edit=(torch.from_numpy(edit_ids), torch.from_numpy(edit_senses)),
        return_ctx_q=True)
    _close(tl, jl)
    assert tq.shape == (2, 12, 4, tc.sense_head_dim)
    _close(tq, jq)


def test_intervention_library_matches_jax(setup):
    """The rest of the module against JAX: the masks and scores, the full
    weighted / negative / replaced-word / counterfactual forwards, sense
    surgery, per-sense logits and the INT8 embedding's dequantization."""
    jc, tc, jp, tp = setup
    ids = _ids(13, 2, 10)
    tids = torch.from_numpy(ids).long()
    table = _table(14)
    tt = torch.from_numpy(table)
    content = np.array(_jit_call(jbp.content_forward, jp, jc, ids))
    E = np.array(jp["gpt"]["wte"])
    scores = np.array(_jit_call(jiv.annealing_scores, E, ids, content,
                                annealing_scale=0.3))
    _close(tiv.annealing_scores(torch.from_numpy(E), tids,
                                torch.from_numpy(content), annealing_scale=0.3),
           scores, atol=1e-5)
    _close(tiv.soft_sense_mask(tt, tids, torch.from_numpy(scores)),
           _jit_call(jiv.soft_sense_mask, table, ids, scores), atol=1e-6)
    for anneal in (False, True):
        _close(tiv.weighted_forward(tp, tc, tids, tt, anneal=anneal),
               jax.jit(lambda p, i, t: jiv.weighted_forward(
                   p, jc, i, t, anneal=anneal))(jp, ids, table), f"w {anneal}")
    _close(tiv.negative_weighted_forward(tp, tc, tids, tt, quantile=QUANTILE,
                                         key_chunk=4),
           jax.jit(lambda p, i, t: jiv.negative_weighted_forward(
               p, jc, i, t, quantile=QUANTILE, key_chunk=4))(jp, ids, table))
    jedit = _jit_call(jiv.mogrify_word, jp, jc, int(ids[0, 2]), 7, 9)
    tedit = tiv.mogrify_word(tp, tc, int(ids[0, 2]), 7, 9)
    assert tedit[0].tolist() == np.asarray(jedit[0]).tolist()
    _close(tedit[1], jedit[1], atol=1e-5)
    _close(tiv.replaced_word_forward(tp, tc, tids, *tedit),
           jax.jit(lambda p, i, e, s: jiv.replaced_word_forward(p, jc, i, e, s))(
               jp, ids, *jedit))
    words = np.array([ids[0, 1], ids[1, 4]], np.int32)
    _close(tiv.counterfactual_forward(tp, tc, tids, torch.from_numpy(words), 2,
                                      0.3),
           jax.jit(lambda p, i, w: jiv.counterfactual_forward(p, jc, i, w, 2, 0.3))(
               jp, ids, words))
    senses = tiv.senses_of_word(tp, tc, 17)
    jsenses = _jit_call(jiv.senses_of_word, jp, jc, 17)
    _close(senses, jsenses, atol=1e-5)
    _close(tiv.per_sense_logits(tp, tc, senses),
           _jit_call(jiv.per_sense_logits, jp, jc, jsenses))
    d = E[3] - E[4]
    _close(tiv.project_out_and_in(senses, torch.from_numpy(E[3]),
                                  torch.from_numpy(E[4])),
           _jit_call(jiv.project_out_and_in, np.asarray(senses.numpy()), E[3], E[4]),
           atol=1e-5)
    for word_ids in (None, np.array([1, 5, 9])):
        _close(tiv.project_out_embeddings(
                   torch.from_numpy(E), torch.from_numpy(d), 0.25,
                   None if word_ids is None else torch.from_numpy(word_ids)),
               _jit_call(jiv.project_out_embeddings, E, d, 0.25, word_ids), atol=1e-5)
    jq8 = jqz.quantize_backpack_params(jp, jc, bits=8)
    tq8 = params_from_numpy(jax.tree.map(np.asarray, jq8), device="cpu")
    _close(tiv.embedding_matrix(tq8["gpt"]),
           _jit_call(lambda g: jiv.embedding_matrix(g).astype(jnp.float32), jq8["gpt"]),
           atol=0)
    x = torch.from_numpy(np.random.default_rng(15).normal(size=(3, 4, 1001))
                         .astype(np.float32))
    for q in (0.02, 0.5, 0.95):
        _close(tiv._quantile(x, q), _jit_call(jnp.quantile, x.numpy(), q, axis=-1), atol=0)


def test_int8_cache_decode_steps_match_jax(setup):
    """Both decode steps over the INT8 cache (ctx-K and senses dequantized
    as JAX does, annealed), against JAX's; the mixed int4 cache, which JAX
    does not compute, and a staged cache raise."""
    jc, tc, jp, tp = setup
    table = _table(16)
    tt = torch.from_numpy(table)
    for mode in ("weighted", "negative"):
        ids = _ids(17, 2, 5)
        jcache = _jax_init(jbp.init_backpack_cache, jc, 2, MAX_LEN, dtype=jnp.int8)
        tcache = tbp.init_backpack_cache(tc, 2, MAX_LEN, torch.int8,
                                         device="cpu")
        if mode == "weighted":
            jstate = _jax_init(jiv.init_weighted_decode_state, jc, 2, MAX_LEN)
            tstate = tiv.init_weighted_decode_state(tc, 2, MAX_LEN, device="cpu")
            step = _jax_weighted(jc, True)
        else:
            jstate = _jax_init(jiv.init_negative_decode_state, jc, 2, MAX_LEN,
                               quantile=QUANTILE)
            tstate = tiv.init_negative_decode_state(tc, 2, MAX_LEN,
                                                    quantile=QUANTILE,
                                                    device="cpu")
            neg = _jax_negative(jc, True)
            step = lambda *a: neg(*a, None, None, None)    # noqa: E731
        for i in range(4):
            jl, jcache, jstate = step(jp, ids, jcache, jstate, table)
            if mode == "weighted":
                tl, tcache, tstate = tiv.weighted_decode_step(
                    tp, tc, torch.from_numpy(ids).long(), tcache, tstate, tt,
                    anneal=True, annealing_scale=0.2)
            else:
                tl, tcache, tstate = tiv.negative_decode_step(
                    tp, tc, torch.from_numpy(ids).long(), tcache, tstate, tt,
                    anneal=True, annealing_scale=0.2, quantile=QUANTILE)
            _close(tl, jl, f"{mode} step {i}")
            ids = _greedy(jl)
    ids = torch.from_numpy(_ids(18, 2, 4)).long()
    c4 = tbp.init_backpack_cache(tc, 2, MAX_LEN, torch.int8, device="cpu", bits=4)
    st = tiv.init_weighted_decode_state(tc, 2, MAX_LEN, device="cpu")
    with pytest.raises(NotImplementedError, match="int4"):
        tiv.weighted_decode_step(tp, tc, ids, c4, st, tt, anneal=True)
    logits, _, _ = tiv.weighted_decode_step(tp, tc, ids, c4, st, tt,
                                            anneal=False)
    assert torch.isfinite(logits).all()
    staged = tbp.init_backpack_cache(tc, 2, MAX_LEN, torch.float32, device="cpu",
                                     per_slot=True, stage=4)
    nst = tiv.init_negative_decode_state(tc, 2, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="unstaged"):
        tiv.negative_decode_step(tp, tc, ids, staged, nst, tt)
