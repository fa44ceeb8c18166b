"""The port's intervention evals against the JAX package's, on the CPU.

eval/control.py, eval/toxicity.py, eval/genderbias.py, eval/visualize.py
and eval/similarity.py of both packages on the same ``backpack_test()``
weights (crossed over through ``params_from_numpy``, the word embedding
scaled by 20 as in tests/test_torch_engine.py so that greedy argmaxes are
not near-ties): scores to 1e-5, weight tables equal, generated token ids
equal at f32 weights, the gender-bias figures and the introspection arrays
close, and ``spearman`` against scipy. The external scorers are callables
here as there; the tokenizer is a stand-in over a fixed word list.
"""

import jax
import numpy as np
import pytest
import scipy.stats
import torch

from backpacks_flash_attn_tpu import config as jcfg
from backpacks_flash_attn_tpu.eval import control as jctl
from backpacks_flash_attn_tpu.eval import genderbias as jgb
from backpacks_flash_attn_tpu.eval import similarity as jsim
from backpacks_flash_attn_tpu.eval import toxicity as jtox
from backpacks_flash_attn_tpu.eval import visualize as jvis
from backpacks_flash_attn_tpu.models import backpack as jbp
from backpacks_flash_attn_tpu_torch import config as tcfg
from backpacks_flash_attn_tpu_torch.eval import control as tctl
from backpacks_flash_attn_tpu_torch.eval import genderbias as tgb
from backpacks_flash_attn_tpu_torch.eval import similarity as tsim
from backpacks_flash_attn_tpu_torch.eval import toxicity as ttox
from backpacks_flash_attn_tpu_torch.eval import visualize as tvis
from backpacks_flash_attn_tpu_torch.utils.weights import params_from_numpy

torch.set_num_threads(1)

WORDS = [11, 57, 230, 301, 499]
PROMPTS = np.random.default_rng(0).integers(0, 512, (2, 6)).astype(np.int32)
# the JAX full forwards of genderbias on XLA's attention, as its own tests
# run them (tests/eval/test_genderbias.py)
XLA = dict(use_flash=False)


@pytest.fixture(scope="module")
def setup():
    jc, tc = jcfg.backpack_test(), tcfg.backpack_test()
    jparams = jbp.init_backpack(jc, jax.random.PRNGKey(0))
    jparams["gpt"]["wte"] = jparams["gpt"]["wte"] * 20.0
    return jc, tc, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _close(t, j, atol=1e-5, rtol=0.0, err_msg=""):
    t = t.detach().float().numpy() if isinstance(t, torch.Tensor) else t
    np.testing.assert_allclose(np.asarray(t, np.float32),
                               np.asarray(j, np.float32), atol=atol, rtol=rtol,
                               err_msg=err_msg)


def test_control_matches_jax(setup):
    """Localization scores, the bucketed tables of every strength, the
    controlled generations and the experiment loop (scorer included), and
    the per-sense vocabulary ranking."""
    jc, tc, jp, tp = setup
    V = tc.padded_vocab_size
    _close(tctl.target_vector(WORDS, V), jctl.target_vector(WORDS, V), atol=0)
    tv = jctl.target_vector(WORDS, V)
    jscores = jctl.sense_vocab_scores(jp, jc, tv, chunk=96)
    tscores = tctl.sense_vocab_scores(tp, tc, torch.from_numpy(np.array(tv)),
                                      chunk=96)
    assert tscores.shape == (tc.num_senses, V)
    _close(tscores, jscores, rtol=1e-5, atol=1e-6)
    # the same scores into both bucketings: the tables equal exactly
    _close(tctl.weights_from_scores(torch.from_numpy(np.array(jscores))),
           jctl.weights_from_scores(jscores), atol=0)
    for strength in (0, 3):
        (jt, ja), (tt, ta) = (jctl.control_weights(jp, jc, WORDS, strength),
                              tctl.control_weights(tp, tc, WORDS, strength))
        assert ta == ja and tt.shape == (V, tc.num_senses)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    table, ann = jctl.control_weights(jp, jc, WORDS, 2)
    jg = jctl.generate_weighted(jp, jc, PROMPTS, table, annealing_scale=ann,
                                max_new_tokens=6)
    tg = tctl.generate_weighted(tp, tc, PROMPTS, np.asarray(table),
                                annealing_scale=ann, max_new_tokens=6)
    assert tg.tolist() == np.asarray(jg).tolist()
    scorer = lambda gens: {"mean_id": float(np.mean(gens))}   # noqa: E731
    jr = jctl.run_control_experiment(jp, jc, WORDS, PROMPTS, strengths=(0, 1),
                                     max_new_tokens=4, scorer=scorer)
    tr = tctl.run_control_experiment(tp, tc, WORDS, PROMPTS, strengths=(0, 1),
                                     max_new_tokens=4, scorer=scorer)
    for s in (0, 1):
        assert tr[s]["generations"].tolist() == jr[s]["generations"].tolist()
        assert tr[s]["metrics"] == jr[s]["metrics"]
    jv, tvv = (jctl.top_vocab_per_sense(jp, jc, 57, k=5),
               tctl.top_vocab_per_sense(tp, tc, 57, k=5))
    for s in range(tc.num_senses):
        assert tvv[s]["top_ids"] == jv[s]["top_ids"]
        assert tvv[s]["bottom_ids"] == jv[s]["bottom_ids"]
        _close(np.array(tvv[s]["top_scores"]), jv[s]["top_scores"], atol=1e-4)


def test_toxicity_matches_jax(setup):
    """The -1 target, the 90/80/60 bucketing, the table and annealing scale,
    suppressed generations (greedy) and the experiment loop with its
    ratio and mean from a scorer's 'toxicity' vector."""
    jc, tc, jp, tp = setup
    V = tc.padded_vocab_size
    _close(ttox.negative_target_vector(WORDS, V),
           jtox.negative_target_vector(WORDS, V), atol=0)
    scores = np.random.default_rng(1).normal(size=(4, V)).astype(np.float32)
    _close(ttox.ninety_weights_from_scores(torch.from_numpy(scores)),
           jtox.ninety_weights_from_scores(scores), atol=0)
    (jt, ja), (tt, ta) = (jtox.toxicity_weights(jp, jc, WORDS),
                          ttox.toxicity_weights(tp, tc, WORDS))
    assert ta == ja
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    jg = jtox.generate_negative(jp, jc, PROMPTS, jt, quantile=0.05,
                                max_new_tokens=5)
    tg = ttox.generate_negative(tp, tc, PROMPTS, np.asarray(jt), quantile=0.05,
                                max_new_tokens=5)
    assert tg.tolist() == np.asarray(jg).tolist()
    scorer = lambda gens: {"toxicity": (gens % 7) / 6.0}     # noqa: E731
    jr = jtox.run_toxicity_experiment(jp, jc, WORDS, PROMPTS, max_new_tokens=3,
                                      scorer=scorer)
    tr = ttox.run_toxicity_experiment(tp, tc, WORDS, PROMPTS, max_new_tokens=3,
                                      scorer=scorer)
    assert set(tr) == set(jr) == {"suppressed", "baseline"}
    for name in jr:
        assert tr[name]["generations"].tolist() == \
            jr[name]["generations"].tolist()
        assert (tr[name]["ratio"], tr[name]["avg"]) == (jr[name]["ratio"],
                                                        jr[name]["avg"])
    gen = torch.Generator().manual_seed(0)
    sampled = ttox.generate_negative(tp, tc, PROMPTS, np.asarray(jt),
                                     max_new_tokens=5, temperature=1.0,
                                     generator=gen)
    assert sampled.shape == (2, 5) and ((0 <= sampled) & (sampled < V)).all()


def test_genderbias_matches_jax(setup):
    """Counterfactual pronoun logits, the bias score and divergence at a
    fixed percent, the fitted experiment, and the projection baseline."""
    jc, tc, jp, tp = setup
    prompts = [PROMPTS[0].tolist(), PROMPTS[1, :5].tolist()]
    kw = dict(him_id=7, her_id=9, job_ids=[int(PROMPTS[0, 2]),
                                          int(PROMPTS[1, 1])], sense_index=2)
    _close(tgb.pronoun_logits(tp, tc, prompts[0], job_ids=kw["job_ids"],
                              sense_index=2, percent=0.4),
           jgb.pronoun_logits(jp, jc, prompts[0], job_ids=kw["job_ids"],
                              sense_index=2, percent=0.4, **XLA), atol=1e-4)
    for fn in ("bias_score", "divergence"):
        _close(getattr(tgb, fn)(tp, tc, prompts, percent=0.3, **kw),
               getattr(jgb, fn)(jp, jc, prompts, percent=0.3, **kw, **XLA),
               atol=0, rtol=1e-4, err_msg=fn)
    jr = jgb.run_genderbias_experiment(jp, jc, prompts, prompts[::-1],
                                       maxiter=6, **kw, **XLA)
    tr = tgb.run_genderbias_experiment(tp, tc, prompts, prompts[::-1],
                                       maxiter=6, **kw)
    assert set(tr) == set(jr)
    for key in jr:
        _close(tr[key], jr[key], atol=0, rtol=1e-4, err_msg=key)
    _close(tgb.baseline_projection_logits(tp, tc, prompts[0], him_id=7,
                                          her_id=9, percent=0.2),
           jgb.baseline_projection_logits(jp, jc, prompts[0], him_id=7,
                                          her_id=9, percent=0.2, **XLA),
           atol=1e-4)


def test_visualize_matches_jax(setup):
    jc, tc, jp, tp = setup
    _close(tvis.sense_matrix(tp, tc, WORDS), jvis.sense_matrix(jp, jc, WORDS))
    for sense in (None, 1):
        jpca = jvis.sense_pca(jp, jc, WORDS, sense=sense)
        tpca = tvis.sense_pca(tp, tc, WORDS, sense=sense)
        _close(tpca["explained"], jpca["explained"], atol=1e-4)
        # components are defined up to sign
        _close(np.abs(tpca["projected"]), np.abs(jpca["projected"]), atol=1e-4)
    _close(tvis.sense_similarity_matrix(tp, tc, WORDS, 3),
           jvis.sense_similarity_matrix(jp, jc, WORDS, 3), atol=1e-5)
    _close(tvis.cross_sense_similarity(tp, tc, 57),
           jvis.cross_sense_similarity(jp, jc, 57), atol=1e-5)
    _close(tvis.localize_prediction(tp, tc, PROMPTS[0], 88),
           jvis.localize_prediction(jp, jc, PROMPTS[0], 88), atol=1e-4)


class _Tokenizer:
    """A stand-in tokenizer: ' word' -> two ids derived from the word."""

    def __call__(self, text):
        h = sum(map(ord, text))
        return {"input_ids": [h % 512, (h * 7) % 512][:1 + len(text) % 2]}


def test_similarity_matches_jax_and_scipy(setup, tmp_path):
    """The loaders on files written here, the word vectors (embedding and
    senses) through a stand-in tokenizer, every similarity measure, and
    spearman against scipy (ties included)."""
    jc, tc, jp, tp = setup
    words = ["cat", "dog", "tree", "house", "river", "stone"]
    rng = np.random.default_rng(2)
    pairs = [(a, b, float(rng.integers(0, 10))) for a in words for b in words
             if a < b]
    files = {
        "rg65": ("".join(f"{a};{b};{g}\n" for a, b, g in pairs), {}),
        "ws353": ("w1,w2,score\n" + "".join(f"{a},{b},{g}\n"
                                             for a, b, g in pairs), {}),
        "simlex999": ("w1\tw2\tpos\tscore\n" + "".join(
            f"{a}\t{b}\tN\t{g}\n" for a, b, g in pairs), {}),
        "simverb3500": ("".join(f"{a}\t{b}\tV\t{g}\n" for a, b, g in pairs), {}),
    }
    data = {}
    for name, (text, _) in files.items():
        path = tmp_path / f"{name}.txt"
        path.write_text(text)
        t = getattr(tsim, f"load_{name}")(str(path))
        j = getattr(jsim, f"load_{name}")(str(path))
        assert [(p.word1, p.word2, p.gold_score) for p in t] == \
            [(p.word1, p.word2, p.gold_score) for p in j] and len(t) == len(pairs)
        data[name] = t
    tok = _Tokenizer()
    for use_first in (False, True):
        tv, jv = (tsim.softmax_vecs(tp, words, tok, use_first=use_first),
                  jsim.softmax_vecs(jp, words, tok, use_first=use_first))
        for w in words:
            _close(tv[w], jv[w])
    tsv = tsim.sense_vecs(tp, tc, words, tok)
    jsv = jsim.sense_vecs(jp, jc, words, tok)
    for w in words:
        _close(tsv[w], jsv[w])
    fns = tsim.similarity_fns(tc.num_senses, multivec=True)
    assert set(fns) == set(jsim.similarity_fns(jc.num_senses, multivec=True))
    t_all = tsim.evaluate_all(data, tsv, fns)
    j_all = jsim.evaluate_all(data, jsv, jsim.similarity_fns(jc.num_senses,
                                                             multivec=True))
    for dname in data:
        for fname in fns:
            assert t_all[dname][fname]["n"] == len(pairs)
            _close(t_all[dname][fname]["spearmanr"],
                   j_all[dname][fname]["spearmanr"], atol=1e-4)
    for a, b in ((rng.normal(size=40), rng.normal(size=40)),
                 (rng.integers(0, 5, 40), rng.integers(0, 5, 40))):
        assert tsim.spearman(a, b) == pytest.approx(
            scipy.stats.spearmanr(a, b).correlation, abs=1e-12)
