"""The port's last evals against the JAX package's, on the CPU: the
lm-evaluation-harness adapter (eval/lm_harness.py), MAUVE (eval/mauve.py)
and the figures (eval/plots.py).

``backpack_test()`` / ``gpt2_test()`` weights cross over through
``params_from_numpy`` at f32; the JAX side runs ``use_flash=False`` as its
own tests do. Log-likelihoods are held to ``rtol=1e-4, atol=1e-4`` (JAX's
own tests' tolerance against a manual forward), features to ``atol=1e-4``,
generated ids and greedy flags must be equal, and the numpy MAUVE pipeline
(copied) must give the JAX package's numbers exactly on the same features.
"""

import os

import jax
import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu import config as jcfg
from backpacks_flash_attn_tpu.eval import lm_harness as jlh
from backpacks_flash_attn_tpu.eval import mauve as jmv
from backpacks_flash_attn_tpu.eval import plots as jplots
from backpacks_flash_attn_tpu.models import backpack as jbp
from backpacks_flash_attn_tpu.models import gpt as jgpt
from backpacks_flash_attn_tpu_torch import config as tcfg
from backpacks_flash_attn_tpu_torch.eval import lm_harness as tlh
from backpacks_flash_attn_tpu_torch.eval import mauve as tmv
from backpacks_flash_attn_tpu_torch.eval import plots as tplots
from backpacks_flash_attn_tpu_torch.utils.weights import params_from_numpy

torch.set_num_threads(1)


class IdTok:
    """Space-separated token ids (the harness needs encode/decode only)."""

    def encode(self, text):
        return [int(t) for t in text.split()]

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


def _text(rng, lo, hi):
    return " ".join(str(int(t)) for t in rng.integers(1, 500, rng.integers(lo, hi)))


@pytest.fixture(scope="module")
def bp_setup():
    jc, tc = jcfg.backpack_test(), tcfg.backpack_test()
    jparams = jbp.init_backpack(jc, jax.random.PRNGKey(11))
    jparams["gpt"]["wte"] = jparams["gpt"]["wte"] * 20.0
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    kw = dict(batch_size=4, eot_token_id=0, buckets=(8, 16, 32))
    return (jlh.HarnessLM.backpack(jparams, jc, IdTok(), use_flash=False, **kw),
            tlh.HarnessLM.backpack(tparams, tc, IdTok(), **kw), jparams, tparams)


def _scores_close(got, want):
    assert len(got) == len(want)
    for (glp, gg), (wlp, wg) in zip(got, want):
        np.testing.assert_allclose(glp, wlp, rtol=1e-4, atol=1e-4)
        assert gg == wg


def test_backpack_loglikelihoods_match_jax(bp_setup):
    jlm, tlm, _, _ = bp_setup
    rng = np.random.default_rng(0)
    reqs = [(_text(rng, 0, 20), _text(rng, 1, 10)) for _ in range(9)]
    reqs.append(("", "3 4 5"))
    _scores_close(tlm.loglikelihood(reqs), jlm.loglikelihood(reqs))
    texts = [_text(rng, 40, 80), _text(rng, 1, 5)]      # windows of 31
    np.testing.assert_allclose(tlm.loglikelihood_rolling(texts),
                               jlm.loglikelihood_rolling(texts),
                               rtol=1e-4, atol=1e-4)
    items = [{"context": _text(rng, 2, 8),
              "choices": [_text(rng, 1, 4) for _ in range(3)], "gold": g}
             for g in (0, 1, 2, 1)]
    assert tlh.multiple_choice_accuracy(tlm, items) == \
        jlh.multiple_choice_accuracy(jlm, items)
    with pytest.raises(ImportError):
        tlm.to_lm_eval()


def test_gpt_loglikelihoods_match_jax():
    jc, tc = jcfg.gpt2_test(), tcfg.gpt2_test()
    jparams = jgpt.init_gpt_lm(jc, jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    kw = dict(batch_size=2, eot_token_id=0, buckets=(16,))
    rng = np.random.default_rng(1)
    reqs = [(_text(rng, 1, 10), _text(rng, 1, 5)) for _ in range(5)]
    _scores_close(tlh.HarnessLM.gpt(tparams, tc, IdTok(), **kw).loglikelihood(reqs),
                  jlh.HarnessLM.gpt(jparams, jc, IdTok(), use_flash=False,
                                    **kw).loglikelihood(reqs))


def test_generate_until_loop_and_served_match_jax(bp_setup):
    """The loop (one generation a prompt) and the served path (the serving
    engine, cache in the params' dtype) each equal JAX's, ids and stops."""
    jlm, tlm, jparams, tparams = bp_setup
    rng = np.random.default_rng(2)
    reqs = [(_text(rng, 1, 12), {"until": [], "max_gen_toks": 6})
            for _ in range(5)]
    want = jlm.generate_until(reqs)
    got = tlm.generate_until(reqs)
    assert got == want and all(len(g.split()) == 6 for g in got)
    stop = " ".join(want[0].split()[2:4])
    cut = tlm.generate_until([(reqs[0][0], {"until": [stop], "max_gen_toks": 6})])
    assert cut == [want[0][:want[0].find(stop)]]
    jc, tc = jcfg.backpack_test(), tcfg.backpack_test()
    kw = dict(batch_size=4, eot_token_id=0, buckets=(16, 32), engine=True)
    jserved = jlh.HarnessLM.backpack(jparams, jc, IdTok(), use_flash=False, **kw)
    tserved = tlh.HarnessLM.backpack(tparams, tc, IdTok(), **kw)
    assert tserved._engine.cache_dtype == torch.float32
    assert tserved.generate_until(reqs) == jserved.generate_until(reqs)


@pytest.mark.parametrize("model", ["gpt", "backpack"])
def test_mauve_features_and_scores_match_jax(model):
    if model == "gpt":
        jc, tc = jcfg.gpt2_test(), tcfg.gpt2_test()
        jparams = jgpt.init_gpt_lm(jc, jax.random.PRNGKey(0))
    else:
        jc, tc = jcfg.backpack_test(), tcfg.backpack_test()
        jparams = jbp.init_backpack(jc, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(5)
    texts = [list(rng.integers(0, jc.vocab_size, rng.integers(3, 12)))
             for _ in range(40)]
    want = jmv.featurize_terminal_hidden(jparams, jc, texts, model=model,
                                         batch_size=16)
    got = tmv.featurize_terminal_hidden(tparams, tc, texts, model=model,
                                        batch_size=16)
    assert got.shape == (40, jc.n_embd) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # padding must not leak: a larger max_len gives the same features
    np.testing.assert_allclose(
        tmv.featurize_terminal_hidden(tparams, tc, texts, model=model,
                                      batch_size=16, max_len=16), got, atol=2e-5)
    p, q = want[:20], want[20:]
    jr = jmv.compute_mauve(p, q, num_buckets=4, seed=1)
    tr = tmv.compute_mauve(p, q, num_buckets=4, seed=1)
    assert tr.mauve == jr.mauve and tr.frontier_integral == jr.frontier_integral
    np.testing.assert_array_equal(tr.divergence_curve, jr.divergence_curve)
    assert tmv.compute_mauve(got[:20], got[20:], num_buckets=4, seed=1).mauve == \
        pytest.approx(jr.mauve, abs=1e-3)


def test_mauve_numpy_pipeline_equals_jax():
    rng = np.random.default_rng(3)
    p = rng.normal(size=(150, 8)).astype(np.float32)
    for shift in (0.0, 2.0, 25.0):
        q = rng.normal(size=(150, 8)).astype(np.float32) + shift
        jr, tr = jmv.compute_mauve(p, q, seed=1), tmv.compute_mauve(p, q, seed=1)
        assert (tr.mauve, tr.frontier_integral, tr.num_buckets) == \
            (jr.mauve, jr.frontier_integral, jr.num_buckets)
        np.testing.assert_array_equal(tr.p_hist, jr.p_hist)
    big = rng.normal(size=(260, 8)).astype(np.float32) + 0.5
    assert tmv.run_mauve(p, big, seed=0).mauve == jmv.run_mauve(p, big, seed=0).mauve
    same = tmv.compute_mauve(p[:75], p[75:], seed=1)
    apart = tmv.compute_mauve(p, p + 25.0, seed=1)
    assert same.mauve > 0.9 and apart.mauve < 0.1


def _png_ok(path):
    assert os.path.exists(path)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert os.path.getsize(path) > 1000


def test_plots_write_each_file(tmp_path):
    rng = np.random.default_rng(0)
    curves = {"Transformer+PPLM": {"success": [0.07, 0.08, 0.24],
                                   "quality": [0.95, 0.94, 0.81]},
              "Backpack": {"success": [0.07, 0.12, 0.24],
                           "quality": [0.92, 0.91, 0.90]}}
    dists = [{" he": 0.37, " the": 0.12}, {" she": 0.18, " he": 0.17}]
    v = rng.normal(size=(6, 8))
    n = v / np.linalg.norm(v, axis=-1, keepdims=True)
    paths = [
        tplots.plot_control_frontier(curves, str(tmp_path / "f.png")),
        tplots.plot_next_token_distributions(dists, str(tmp_path / "g.png"),
                                             panel_titles=["a", "b"]),
        tplots.plot_sense_pca({"projected": rng.normal(size=(12, 2)),
                               "explained": np.asarray([0.4, 0.2])},
                              str(tmp_path / "p.png"),
                              labels=[f"w{i}" for i in range(12)],
                              color_by=np.arange(12) % 4),
        tplots.plot_similarity_heatmap(n @ n.T, str(tmp_path / "s.png"),
                                       labels=list("abcdef")),
        tplots.plot_localization(rng.normal(size=(4, 5)), str(tmp_path / "l.png"),
                                 tokens=list("abcde"), target=" x"),
    ]
    for path in paths:
        _png_ok(path)
    rows = [["GPT-2", 0.244, 0.187], ["Backpack", 0.308, 0.255]]
    kw = dict(caption="Spearman", label="tab:simlex")
    assert tplots.latex_table(rows, ["Model", "SimLex", "SimVerb"], **kw) == \
        jplots.latex_table(rows, ["Model", "SimLex", "SimVerb"], **kw)
