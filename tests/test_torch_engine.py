"""The port's serving engine, sampling and scheduler against the JAX
package's, on the CPU.

``backpack_test()`` weights cross over through ``params_from_numpy``, with
the word embedding scaled by 20 so that logits are O(1) and a greedy argmax
is not decided by a last-bit near-tie (random-init logits are ~1e-2 apart,
and XLA and torch round differently). The JAX engine runs three times here
(XLA:CPU fails after ~150 compiles in one process): a mixed request set on
the bucketed path, the same set speculative over chunked prefill, and a
seeded sampling set; each set's tokens equal the port's token for token.
The other engine cases use the JAX tests' own oracle, the port's direct
per-request decode (tests/serving/test_engine.py, test_speculative.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu import config as jcfg
from backpacks_flash_attn_tpu.models import backpack as jbp
from backpacks_flash_attn_tpu.serving.engine import ServingEngine as JEngine
from backpacks_flash_attn_tpu.utils import generation as jgen
from backpacks_flash_attn_tpu_torch import config as tcfg
from backpacks_flash_attn_tpu_torch.models import backpack as tbp
from backpacks_flash_attn_tpu_torch.serving import scheduler as sched_lib
from backpacks_flash_attn_tpu_torch.serving.engine import (
    ServingEngine, prompt_lookup_draft)
from backpacks_flash_attn_tpu_torch.utils import generation as tgen
from backpacks_flash_attn_tpu_torch.utils import prng
from backpacks_flash_attn_tpu_torch.utils.weights import params_from_numpy

torch.set_num_threads(1)

MAX_LEN = 64


@pytest.fixture(scope="module")
def setup():
    jc, tc = jcfg.backpack_test(), tcfg.backpack_test()
    jparams = jbp.init_backpack(jc, jax.random.PRNGKey(0))
    jparams["gpt"]["wte"] = jparams["gpt"]["wte"] * 20.0
    return jc, tc, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _engine(setup, **kw):
    _, tc, _, tp = setup
    kw.setdefault("max_slots", 3)
    kw.setdefault("max_seqlen", MAX_LEN)
    kw.setdefault("eos_id", -1)
    return ServingEngine(tp, tc, cache_dtype=torch.float32, device="cpu", **kw)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).tolist() for n in lengths]


def _mixed_set():
    """Ragged prompts (one longer than a bucket of 8, one of 20), more
    requests than slots (slot reuse), budgets past the 8-column stage."""
    prompts = _prompts(0, (3, 9, 5, 12, 4, 20, 7))
    budgets = [10, 14, 6, 12, 3, 11, 9]
    return prompts, budgets


def _run_both(setup, prompts, budgets, kw, **engine_kw):
    jc, _, jp, _ = setup
    je = JEngine(jp, jc, max_slots=3, max_seqlen=MAX_LEN, eos_id=-1,
                 cache_dtype=jnp.float32, **engine_kw)
    te = _engine(setup, **engine_kw)
    jr = [je.submit(p, max_new_tokens=n, **k) for p, n, k in
          zip(prompts, budgets, kw)]
    tr = [te.submit(p, max_new_tokens=n, **k) for p, n, k in
          zip(prompts, budgets, kw)]
    jres, tres = je.run(), te.run()
    return ([jres[r].tokens for r in jr], [tres[r].tokens for r in tr],
            je.stats(), te.stats())


def test_engine_matches_jax_engine_across_flushes(setup):
    """Bucketed batch prefill, slot reuse, staging across several flushes
    (stage 8): the port's greedy tokens equal the JAX engine's, and the
    counters agree."""
    prompts, budgets = _mixed_set()
    jt, tt, js, ts = _run_both(setup, prompts, budgets, [{}] * len(prompts),
                               stage_tokens=8)
    assert tt == jt
    assert ts["flushes"] >= 2
    for key in ("admissions", "decode_steps", "tokens_emitted", "completed",
                "prefill_dispatches", "window_histogram"):
        assert ts[key] == js[key], key


def test_speculative_chunked_engine_matches_jax_engine(setup):
    """The same requests with prompt-lookup speculation (3 drafts) over
    chunked prefill (chunks of 8): tokens and draft acceptance equal."""
    prompts, budgets = _mixed_set()
    jt, tt, js, ts = _run_both(setup, prompts, budgets, [{}] * len(prompts),
                               stage_tokens=8, spec_tokens=3,
                               prefill_chunk=8)
    assert tt == jt
    for key in ("decode_steps", "draft_proposed", "draft_accepted",
                "prefill_dispatches"):
        assert ts[key] == js[key], key


def test_seeded_sampling_matches_jax_engine(setup):
    """Seeded temperature, top-k and top-p requests beside a greedy one: the
    keys split as JAX's and the Gumbel draw is jax.random.categorical's on
    them, so the sampled tokens are the JAX engine's."""
    prompts = _prompts(1, (4, 6, 5, 8))
    kw = [dict(temperature=1.0), dict(temperature=0.8, top_k=20),
          dict(temperature=1.2, top_p=0.9), {}]
    jt, tt, _, _ = _run_both(setup, prompts, [8] * 4, kw, seed=3,
                             stage_tokens=8)
    assert tt == jt


def test_generate_backpack_sampling_matches_jax(setup):
    jc, tc, jp, tp = setup
    ids = np.random.default_rng(2).integers(0, 512, (2, 5)).astype(np.int32)
    for kw in (dict(temperature=0.9, top_k=30), dict(temperature=1.0,
                                                     top_p=0.8)):
        jout = jgen.generate_backpack(jp, jc, jnp.asarray(ids), 12,
                                      rng=jax.random.PRNGKey(5),
                                      cache_dtype=jnp.float32, **kw)
        tout = tgen.generate_backpack(tp, tc, torch.from_numpy(ids).long(), 12,
                                      rng=prng.PRNGKey(5),
                                      cache_dtype=torch.float32,
                                      device="cpu", **kw)
        np.testing.assert_array_equal(tout.sequences.numpy(),
                                      np.asarray(jout.sequences))


# ------------------------------------------------------------ port oracle

def _direct(setup, prompt, n, weights=None):
    """The port's direct greedy decode of one request (scalar cache)."""
    _, tc, _, tp = setup
    cache = tbp.init_backpack_cache(tc, 1, MAX_LEN, torch.float32,
                                    device="cpu")
    w = None if weights is None else torch.from_numpy(weights[None])
    logits, cache = tbp.backpack_forward_with_cache(
        tp, tc, torch.tensor([prompt]), cache, sense_weights=w)
    out = []
    for _ in range(n):
        out.append(int(logits[0, -1].argmax()))
        logits, cache = tbp.backpack_forward_with_cache(
            tp, tc, torch.tensor([[out[-1]]]), cache, sense_weights=w)
    return out


@pytest.mark.parametrize("prefer_native", [True, False])
def test_engine_matches_direct_decode(setup, prefer_native):
    prompts = _prompts(3, (3, 9, 5, 12, 4))
    eng = _engine(setup, prefer_native_scheduler=prefer_native,
                  stage_tokens=4)
    got = eng.generate(prompts, max_new_tokens=6)
    assert got == [_direct(setup, p, 6) for p in prompts]


def test_engine_unstaged_and_window_buckets(setup):
    """stage_tokens=0 (per-row writes into the main cache) and a 32-wide
    window bucket give the staged engine's tokens."""
    prompts = _prompts(4, (3, 9, 25))
    want = _engine(setup).generate(prompts, max_new_tokens=12)
    eng = _engine(setup, stage_tokens=0, window_buckets=(32,))
    assert eng.window_buckets == [32, MAX_LEN]
    assert eng.generate(prompts, max_new_tokens=12) == want
    assert set(eng.stats()["window_histogram"]) == {32, MAX_LEN}


def test_engine_eos_and_stop_sequences(setup):
    prompt = [3, 1, 4]
    want = _direct(setup, prompt, 10)
    idx = next(i for i in range(1, 10) if want[i] not in want[:i])
    eng = _engine(setup, eos_id=want[idx])
    rid = eng.submit(prompt, max_new_tokens=10)
    assert eng.run()[rid].tokens == want[:idx + 1]      # stops AT the eos
    for spec in (0, 3):
        eng = _engine(setup, spec_tokens=spec)
        stop = [want[3], want[4]]
        rid = eng.submit(prompt, max_new_tokens=10, stop=[stop])
        got = eng.run()[rid].tokens
        full = got + stop
        assert full == want[:len(full)] and len(full) <= 5


@pytest.mark.parametrize("spec_tokens", [0, 3])
def test_engine_min_tokens_penalties_and_logprobs(setup, spec_tokens):
    _, tc, _, tp = setup
    prompt = [3, 1, 4, 1]
    want = _direct(setup, prompt, 8)
    idx = next(i for i in range(1, 8) if want[i] not in want[:i])
    eng = _engine(setup, eos_id=want[idx], spec_tokens=spec_tokens)
    r = eng.submit(prompt, max_new_tokens=8, min_new_tokens=idx + 3)
    got = eng.run()[r].tokens
    assert len(got) >= idx + 3 and want[idx] not in got[:idx + 2]
    # penalties: the manual penalty-aware greedy loop
    fp, pp = 1.5, 0.5
    eng = _engine(setup, spec_tokens=spec_tokens)
    r = eng.submit(prompt, max_new_tokens=6, frequency_penalty=fp,
                   presence_penalty=pp, logprobs=True)
    res = eng.run()[r]
    counts = np.zeros((tc.padded_vocab_size,))
    for t in prompt:
        counts[t] += 1
    cache = tbp.init_backpack_cache(tc, 1, MAX_LEN, torch.float32,
                                    device="cpu")
    logits, cache = tbp.backpack_forward_with_cache(tp, tc, torch.tensor(
        [prompt]), cache)
    for tok, lp in zip(res.tokens, res.logprobs):
        row = logits[0, -1].double().numpy() - fp * counts - pp * (counts > 0)
        assert tok == int(row.argmax())
        row -= row.max()
        assert abs(lp - (row[tok] - np.log(np.exp(row).sum()))) < 1e-4
        counts[tok] += 1
        logits, cache = tbp.backpack_forward_with_cache(
            tp, tc, torch.tensor([[tok]]), cache)


def test_engine_sense_weights_match_direct_decode(setup):
    prompt = [5, 17, 42, 99]
    w = np.ones(4, np.float32)
    w[1], w[2] = 6.0, 0.1
    eng = _engine(setup, stage_tokens=4)
    r_plain = eng.submit(prompt, max_new_tokens=6)
    r_w = eng.submit(prompt, max_new_tokens=6, sense_weights=w)
    res = eng.run()
    assert res[r_plain].tokens == _direct(setup, prompt, 6)
    assert res[r_w].tokens == _direct(setup, prompt, 6, w)
    assert res[r_w].tokens != res[r_plain].tokens


def test_engine_sampling_reproducible_and_restricted(setup):
    """Seeded sampling reproduces; top_k = 1 and a tiny top_p keep only the
    argmax, so they equal greedy decoding; top-k restricts every draw to
    the k most likely tokens."""
    prompt = [2, 7, 1]

    def run(seed, **kw):
        eng = _engine(setup, seed=seed)
        rid = eng.submit(prompt, max_new_tokens=8, temperature=1.0, **kw)
        return eng.run()[rid].tokens

    assert run(0) == run(0) and run(0) != run(1)
    greedy = _direct(setup, prompt, 8)
    assert run(0, top_k=1) == greedy and run(0, top_p=1e-6) == greedy
    _, tc, _, tp = setup
    got = run(4, top_k=3)
    cache = tbp.init_backpack_cache(tc, 1, MAX_LEN, torch.float32,
                                    device="cpu")
    logits, cache = tbp.backpack_forward_with_cache(tp, tc, torch.tensor(
        [prompt]), cache)
    for tok in got:
        assert tok in logits[0, -1].topk(3).indices.tolist()
        logits, cache = tbp.backpack_forward_with_cache(
            tp, tc, torch.tensor([[tok]]), cache)


def test_model_draft_speculation_is_exact(setup):
    """The model itself as its draft, over more requests than slots: the
    output is plain greedy decoding, and acceptance is high (below 1: the
    draft cache misses position t + k after a fully accepted step, as the
    JAX engine's does, ROADMAP Queue 3)."""
    _, tc, _, tp = setup
    prompts = _prompts(5, (4, 7, 5, 6))
    eng = _engine(setup, spec_tokens=3, draft_params=tp, draft_cfg=tc,
                  draft_cache_dtype=torch.float32, stage_tokens=8)
    got = eng.generate(prompts, max_new_tokens=9)
    assert got == [_direct(setup, p, 9) for p in prompts]
    st = eng.stats()
    assert st["draft_source"] == "model" and st["draft_acceptance"] > 0.5


def test_engine_rejects_what_it_cannot_serve(setup):
    _, tc, _, tp = setup
    eng = _engine(setup, max_seqlen=16)
    with pytest.raises(ValueError, match="cannot fit"):
        eng.submit(list(range(16)), max_new_tokens=4)
    for bad in (dict(top_p=0.0), dict(top_p=1.5), dict(top_k=-1),
                dict(control=True)):
        with pytest.raises(ValueError):
            eng.submit([1, 2], **bad)
    table = np.ones((tc.padded_vocab_size, 4), np.float32)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        ServingEngine(tp, tc, control_table=table, device="cpu")


def test_engine_stats_surface(setup):
    eng = _engine(setup, max_slots=4)
    prompts = _prompts(6, (3, 7, 5))
    res = eng.generate(prompts, max_new_tokens=4)
    s = eng.stats()
    assert s["admissions"] == 3 and s["completed"] == 3
    assert s["tokens_emitted"] + s["admissions"] == sum(map(len, res))
    assert sum(s["window_histogram"].values()) == s["decode_steps"]
    assert s["mean_step_ms"] > 0 and 0 < s["mean_batch"] <= 4


def test_prompt_lookup_draft():
    hist = np.array([5, 6, 7, 8, 5, 6], np.int32)
    assert prompt_lookup_draft(hist, 3).tolist() == [7, 8, 5]
    assert prompt_lookup_draft(np.array([4], np.int32), 2).tolist() == [4, 4]


# ------------------------------------------------------------ scheduler

def _impls():
    return [sched_lib.PyScheduler, sched_lib.NativeScheduler]


def test_native_scheduler_builds():
    assert sched_lib.native_available()
    assert isinstance(sched_lib.make_scheduler(2, 8, 0),
                      sched_lib.NativeScheduler)


@pytest.mark.parametrize("impl", _impls())
def test_scheduler_lifecycle(impl):
    s = impl(2, 16, eos_id=99)
    assert s.submit(10, 4, 8) and s.submit(11, 3, 2) and s.submit(12, 5, 20)
    assert not s.submit(13, 20, 8)
    assert s.admit() == (0, 10, 4) and s.admit() == (1, 11, 3)
    assert s.admit() is None
    assert not s.on_token(1, 5) and s.on_token(1, 7)
    assert s.slot_tokens(1) == [5, 7]
    s.release(1)
    assert s.admit() == (1, 12, 5)
    assert s.on_token(0, 99) and s.completed == 2
    with pytest.raises(ValueError):
        s.on_token(0, 1)


def test_scheduler_cpp_python_conformance():
    """Random op streams: the C++ scheduler and its Python twin make the
    same decisions step for step."""
    rng = np.random.default_rng(0)
    cpp = sched_lib.NativeScheduler(4, 32, eos_id=7)
    py = sched_lib.PyScheduler(4, 32, eos_id=7)
    rid = 0
    for _ in range(2000):
        op = rng.integers(0, 4)
        if op == 0:
            plen, mnt = int(rng.integers(0, 40)), int(rng.integers(1, 10))
            assert cpp.submit(rid, plen, mnt) == py.submit(rid, plen, mnt)
            rid += 1
        elif op == 1:
            assert cpp.admit() == py.admit()
        elif op == 2:
            slot, tok = int(rng.integers(0, 4)), int(rng.integers(0, 12))
            if py.slot_active(slot):
                assert cpp.on_token(slot, tok) == py.on_token(slot, tok)
                assert cpp.slot_tokens(slot) == py.slot_tokens(slot)
        else:
            slot = int(rng.integers(0, 4))
            if not py.slot_active(slot):
                cpp.release(slot)
                py.release(slot)
        assert (cpp.num_pending, cpp.num_active) == (py.num_pending,
                                                     py.num_active)
    assert cpp.completed == py.completed
