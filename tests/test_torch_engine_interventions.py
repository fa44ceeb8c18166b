"""The port's serving engine with control and negative requests, on the CPU.

Control (annealed topic control), negative (toxicity removal), sense-
weighted and plain requests share the slots of one engine, over more
requests than slots, so slots retire and refill under every mode. Weights
are ``backpack_test()``'s with the word embedding scaled by 20, as in
tests/test_torch_engine.py (logits O(1), greedy argmaxes not decided by a
last-bit near-tie). The JAX engine runs twice (one control run, one negative
run with control requests beside), and the port's tokens equal its tokens;
the port's control and negative requests also equal the port's own
``generate_weighted`` / ``generate_negative`` (tests/serving/
test_engine.py:139,199).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu import config as jcfg
from backpacks_flash_attn_tpu.models import backpack as jbp
from backpacks_flash_attn_tpu.serving.engine import ServingEngine as JEngine
from backpacks_flash_attn_tpu_torch import config as tcfg
from backpacks_flash_attn_tpu_torch.eval.control import generate_weighted
from backpacks_flash_attn_tpu_torch.eval.toxicity import generate_negative
from backpacks_flash_attn_tpu_torch.models import backpack as tbp
from backpacks_flash_attn_tpu_torch.serving.engine import ServingEngine
from backpacks_flash_attn_tpu_torch.utils.weights import params_from_numpy

torch.set_num_threads(1)

MAX_LEN = 64
QUANTILE = 0.05


@pytest.fixture(scope="module")
def setup():
    jc, tc = jcfg.backpack_test(), tcfg.backpack_test()
    jparams = jbp.init_backpack(jc, jax.random.PRNGKey(0))
    jparams["gpt"]["wte"] = jparams["gpt"]["wte"] * 20.0
    return jc, tc, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _tables():
    rng = np.random.default_rng(21)
    control = (0.2 + 3.0 * rng.uniform(size=(512, 4))).astype(np.float32)
    negative = (0.4 + 1.2 * rng.uniform(size=(512, 4))).astype(np.float32)
    return control, negative


def _requests(seed, modes):
    """Ragged prompts (one past a bucket of 8, one of 20) and budgets, one
    request a mode letter: p plain, w sense-weighted, c control, n
    negative."""
    rng = np.random.default_rng(seed)
    lens = [3, 9, 5, 12, 4, 20, 7, 6][:len(modes)]
    out = []
    for n, mode in zip(lens, modes):
        kw = {"control": mode == "c", "negative": mode == "n"}
        if mode == "w":
            kw["sense_weights"] = np.array([1.5, 0.5, 1.0, 2.0], np.float32)
        out.append((rng.integers(0, 512, n).tolist(),
                    int(rng.integers(3, 12)), kw))
    return out


def _serve(engine, requests):
    rids = [engine.submit(p, max_new_tokens=n, **kw) for p, n, kw in requests]
    res = engine.run()
    return [res[r].tokens for r in rids]


def _both(setup, requests, **kw):
    jc, tc, jp, tp = setup
    je = JEngine(jp, jc, max_slots=3, max_seqlen=MAX_LEN, eos_id=-1,
                 cache_dtype=jnp.float32, stage_tokens=8, **kw)
    te = ServingEngine(tp, tc, max_slots=3, max_seqlen=MAX_LEN, eos_id=-1,
                       cache_dtype=torch.float32, stage_tokens=8, device="cpu",
                       **kw)
    return _serve(je, requests), _serve(te, requests), te


def test_engine_control_requests_match_jax(setup):
    control, _ = _tables()
    requests = _requests(0, "cpwcpcp")
    jtok, ttok, te = _both(setup, requests, control_table=control,
                           annealing_scale=0.3)
    assert ttok == jtok
    assert te.stats()["completed"] == len(requests)
    assert te.istate is not None and te.nstate is None


def test_engine_negative_requests_match_jax(setup):
    """Negative, control and plain slots share the batch (the JAX engine's
    negative step carries the control slots)."""
    control, negative = _tables()
    requests = _requests(1, "npcnpnc")
    jtok, ttok, te = _both(setup, requests, control_table=control,
                           annealing_scale=0.3, negative_table=negative,
                           negative_quantile=QUANTILE)
    assert ttok == jtok
    m = te.nstate.neg_vals.shape[-1]
    assert m == 26 and te.nstate.nbytes() > 2 * 3 * MAX_LEN * 4 * m * 4


def test_engine_interventions_match_generate(setup):
    """The port's engine against the port's uniform-batch generators: each
    control request equals generate_weighted, each negative request
    generate_negative, each plain one the plain greedy decode; and each
    intervention changes some request's output."""
    _, tc, _, tp = setup
    control, negative = _tables()
    eng = ServingEngine(tp, tc, max_slots=2, max_seqlen=MAX_LEN, eos_id=-1,
                        cache_dtype=torch.float32, device="cpu",
                        control_table=control, annealing_scale=0.3,
                        negative_table=negative, negative_quantile=QUANTILE)
    requests = _requests(2, "cnpcn")
    got = _serve(eng, requests)
    changed = {"control": False, "negative": False}
    for (prompt, n, kw), tokens in zip(requests, got):
        ids = np.asarray([prompt], np.int32)
        if kw["control"]:
            want = generate_weighted(tp, tc, ids, control, annealing_scale=0.3,
                                     max_new_tokens=n, max_seqlen=MAX_LEN)
        elif kw["negative"]:
            want = generate_negative(tp, tc, ids, negative, quantile=QUANTILE,
                                     max_new_tokens=n, max_seqlen=MAX_LEN)
        else:
            want = [_greedy(tp, tc, prompt, n)]
        assert tokens == list(want[0]), kw
        mode = "control" if kw["control"] else "negative"
        if kw["control"] or kw["negative"]:
            changed[mode] |= tokens != _greedy(tp, tc, prompt, n)
    assert changed == {"control": True, "negative": True}


def _greedy(tp, tc, prompt, n):
    cache = tbp.init_backpack_cache(tc, 1, MAX_LEN, torch.float32, device="cpu")
    logits, cache = tbp.backpack_forward_with_cache(
        tp, tc, torch.tensor([prompt]), cache)
    out = []
    for _ in range(n):
        tok = int(logits[0, -1].argmax())
        out.append(tok)
        logits, cache = tbp.backpack_forward_with_cache(
            tp, tc, torch.tensor([[tok]]), cache)
    return out
