"""The port's PPLM (eval/pplm.py) against the JAX package's, on the CPU.

``gpt2_test()`` weights cross over through ``params_from_numpy``; the same
prompts and bags of words go through ``perturb_cache`` and ``pplm_generate``
in both packages at f32. The perturbed caches are held to ``atol=1e-5,
rtol=0`` (three normalized steps of 0.02 on keys and values of O(1)); the
generated ids must be equal up to the first step where the packages part,
and there the two tokens a near tie of both packages' scores. JAX's ``perturb_cache`` is jitted so each
shape compiles once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu import config as jcfg
from backpacks_flash_attn_tpu.eval import pplm as jpplm
from backpacks_flash_attn_tpu.models import gpt as jgpt
from backpacks_flash_attn_tpu_torch import config as tcfg
from backpacks_flash_attn_tpu_torch.eval import pplm as tpplm
from backpacks_flash_attn_tpu_torch.models import gpt as tgpt
from backpacks_flash_attn_tpu_torch.ops import _build
from backpacks_flash_attn_tpu_torch.utils import prng
from backpacks_flash_attn_tpu_torch.utils.weights import params_from_numpy

torch.set_num_threads(1)

ATOL = 1e-5
S = 16


@pytest.fixture(scope="module")
def setup():
    jc, tc = jcfg.gpt2_test(), tcfg.gpt2_test()
    jparams = jgpt.init_gpt_lm(jc, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jc, tc, jparams, tparams


def _bow(ids, v):
    bow = np.zeros((v,), np.float32)
    bow[list(ids)] = 1.0
    return bow


@functools.lru_cache(maxsize=None)
def _jax_perturb(cfg, window):
    return jax.jit(lambda p, c, t, b: jpplm.perturb_cache(
        p, cfg, c, t, b, stepsize=0.02, num_iterations=3, kl_scale=0.01,
        window=window))


def _caches(setup, prompt):
    """Both packages' f32 caches after the prefill of all but the last
    prompt token; -> (jax cache, port cache, last token)."""
    jc, tc, jparams, tparams = setup
    b = prompt.shape[0]
    jcache = jgpt.init_kv_cache(jc, b, S, jnp.float32)
    _, jcache = jgpt.gpt_forward_with_cache(jparams, jc,
                                            jnp.asarray(prompt[:, :-1]), jcache)
    tcache = tgpt.init_kv_cache(tc, b, S, torch.float32, device="cpu")
    tgpt.gpt_forward_with_cache(tparams, tc, torch.from_numpy(prompt[:, :-1]).long(),
                                tcache)
    return jcache, tcache, prompt[:, -1:]


@pytest.mark.parametrize("window", [None, 3])
def test_perturb_cache_matches_jax(setup, window):
    jc, tc, jparams, tparams = setup
    prompt = np.random.default_rng(1).integers(0, 512, (2, 7)).astype(np.int32)
    jcache, tcache, token = _caches(setup, prompt)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=ATOL)
    bow = _bow([7, 42, 99, 123], tc.padded_vocab_size)
    jpert = _jax_perturb(jc, window)(jparams, jcache, jnp.asarray(token),
                                     jnp.asarray(bow))
    k_before = tcache.k.clone()
    tpert = tpplm.perturb_cache(tparams, tc, tcache, torch.from_numpy(token).long(),
                                torch.from_numpy(bow), stepsize=0.02,
                                num_iterations=3, kl_scale=0.01, window=window)
    L = tcache.length
    # the real cache keeps its length and its valid columns
    assert tcache.length == L == 6
    assert torch.equal(tcache.k[..., :L], k_before[..., :L])
    for name in ("k", "v"):
        t, j = getattr(tpert, name), np.asarray(getattr(jpert, name))
        cut = (slice(None),) * 3 + (slice(0, L),) if name == "k" else \
            (slice(None), slice(None), slice(0, L))
        np.testing.assert_allclose(t.numpy()[cut], j[cut], atol=ATOL, rtol=0,
                                   err_msg=name)
        moved = np.abs(t.numpy()[cut] - getattr(tcache, name).numpy()[cut])
        assert moved.max() > 1e-3, name
        if window is not None:
            # positions before length - window untouched
            head = moved[..., :L - window] if name == "k" else moved[:, :, :L - window]
            assert head.max() == 0.0, name
    # the perturbation raises the bag's probability mass (JAX's property)
    tok = torch.from_numpy(token).long()
    with torch.no_grad():
        m0 = (tpplm._next_token_logprobs(tparams, tc, tok, tcache).exp()
              * torch.from_numpy(bow)).sum(-1)
        m1 = (tpplm._next_token_logprobs(tparams, tc, tok, tpert).exp()
              * torch.from_numpy(bow)).sum(-1)
    assert (m1 > m0).all(), (m0, m1)


def test_perturb_cache_empty_bow_leaves_cache(setup):
    jc, tc, jparams, tparams = setup
    prompt = np.random.default_rng(2).integers(0, 512, (2, 5)).astype(np.int32)
    jcache, tcache, token = _caches(setup, prompt)
    bow = np.zeros((tc.padded_vocab_size,), np.float32)
    tpert = tpplm.perturb_cache(tparams, tc, tcache, torch.from_numpy(token).long(),
                                torch.from_numpy(bow))
    jpert = _jax_perturb(jc, None)(jparams, jcache, jnp.asarray(token),
                                   jnp.asarray(bow))
    L = tcache.length
    assert torch.equal(tpert.k[..., :L], tcache.k[..., :L])
    assert torch.equal(tpert.v[:, :, :L], tcache.v[:, :, :L])
    np.testing.assert_array_equal(np.asarray(jpert.k)[..., :L],
                                  np.asarray(jcache.k)[..., :L])


def test_perturb_cache_gradients_take_the_plain_attention(setup, monkeypatch):
    """The gradient forwards run inside plain_path() and the forward-only
    ones outside it: on the card, K1 runs only where no gradient is taken."""
    jc, tc, jparams, tparams = setup
    prompt = np.random.default_rng(3).integers(0, 512, (1, 4)).astype(np.int32)
    _, tcache, token = _caches(setup, prompt)
    seen = []
    real = tpplm._next_token_logprobs

    def spy(*a):
        seen.append((torch.is_grad_enabled(), _build.kernels_enabled()))
        return real(*a)

    monkeypatch.setattr(tpplm, "_next_token_logprobs", spy)
    tpplm.pplm_generate(tparams, tc, prompt, [5, 6], max_new_tokens=2,
                        num_iterations=3)
    # a step: logp0, three gradient forwards, logp_pert, logp_unpert
    step = [(False, True)] + [(True, False)] * 3 + [(False, True)] * 2
    assert seen == step * 2


def test_bf16_weights_decode_over_the_f32_cache_in_f32(setup, monkeypatch):
    """pplm_generate keeps JAX's f32 cache under bf16 weights: each decode
    step hands the decode kernel's wrapper q in the cache's dtype (K1
    takes q and a floating cache in one dtype; its f32 form) and gives the
    activations back in bf16; the steps' logits agree with the f32
    weights' to bf16 rounding, and the bag's mass still rises."""
    jc, tc, jparams, tparams = setup
    def bf16(tree):
        if isinstance(tree, dict):
            return {k: bf16(v) for k, v in tree.items()}
        return tree.to(torch.bfloat16)

    bparams = bf16(tparams)
    seen = []
    real = tgpt.decode_attention

    def spy(q, kt, *a):
        seen.append((q.dtype, kt.dtype))
        return real(q, kt, *a)

    monkeypatch.setattr(tgpt, "decode_attention", spy)
    prompt = np.random.default_rng(5).integers(0, 512, (2, 6)).astype(np.int32)
    ids = tpplm.pplm_generate(bparams, tc, prompt, [5, 6, 7], max_new_tokens=3,
                              num_iterations=1)
    assert ids.shape == (2, 3) and seen
    assert set(seen) == {(torch.float32, torch.float32)}
    cache = tgpt.init_kv_cache(tc, 2, S, torch.float32, device="cpu")
    tok = torch.from_numpy(prompt[:, -1:]).long()
    tgpt.gpt_forward_with_cache(bparams, tc, torch.from_numpy(prompt[:, :-1]).long(),
                                cache)
    hidden, _ = tgpt.gpt_forward_with_cache(bparams, tc, tok, tgpt.KVCache(
        k=cache.k.clone(), v=cache.v.clone(), length=cache.length))
    assert hidden.dtype == torch.bfloat16
    lp = tpplm._next_token_logprobs(bparams, tc, tok, cache)
    lp32 = tpplm._next_token_logprobs(tparams, tc, tok, cache)
    np.testing.assert_allclose(lp.numpy(), lp32.numpy(), atol=0.05, rtol=0)
    bow = torch.zeros(tc.padded_vocab_size)
    bow[[5, 6, 7]] = 1.0
    pert = tpplm.perturb_cache(bparams, tc, cache, tok, bow, stepsize=0.05,
                               num_iterations=3)
    m0 = (lp.exp() * bow).sum(-1)
    m1 = (tpplm._next_token_logprobs(bparams, tc, tok, pert).exp() * bow).sum(-1)
    assert (m1 > m0).all(), (m0, m1)


@pytest.mark.parametrize("window,temperature", [(None, 0.0), (4, 0.0),
                                                (None, 1.0)])
def test_pplm_generate_ids_match_jax(setup, window, temperature):
    jc, tc, jparams, tparams = setup
    prompt = np.random.default_rng(4).integers(0, 512, (2, 5)).astype(np.int32)
    bow_ids = [7, 42, 99, 123, 200]
    kw = dict(max_new_tokens=6, stepsize=0.05, num_iterations=2,
              kl_scale=0.01, gm_scale=0.9, window=window,
              temperature=temperature)
    want = jpplm.pplm_generate(
        jparams, jc, jnp.asarray(prompt), bow_ids,
        rng=jax.random.PRNGKey(5) if temperature else None, **kw)
    got = tpplm.pplm_generate(tparams, tc, prompt, bow_ids,
                              rng=prng.PRNGKey(5) if temperature else None,
                              **kw)
    assert got.shape == (2, 6) and got.dtype == np.int32
    want = np.asarray(want)
    parted = np.nonzero((got != want).any(axis=0))[0]
    if len(parted) == 0:
        return
    # equal up to the first step where the packages part; there each row's
    # two tokens must be a near tie of both packages' scores on the shared
    # prefix (the fused log-probs, plus the step's Gumbel noise when
    # sampling), which agree within ROW_ATOL
    t = int(parted[0])
    np.testing.assert_array_equal(got[:, :t], want[:, :t])
    prefix = np.concatenate([prompt, got[:, :t]], axis=1)
    tp, jp = _step_scores(setup, prefix, bow_ids, t, kw)
    np.testing.assert_allclose(tp, jp, atol=ROW_ATOL, rtol=0)
    for r in np.nonzero(got[:, t] != want[:, t])[0]:
        a, b = got[r, t], want[r, t]
        for scores in (tp[r], jp[r]):
            gap = abs(scores[a] - scores[b])
            assert gap <= 2 * ROW_ATOL, (r, t, a, b, gap)


# the two packages' f32 scores of one PPLM step agree to this; where their
# argmax parts, the two tokens' scores lie within 2 x ROW_ATOL of each other
ROW_ATOL = 1e-4


def _step_scores(setup, prefix, bow_ids, t, kw):
    """Step t of pplm_generate in both packages on the shared prefix
    (prompt and the first t generated ids): the cache prefilled with all
    but its last id, that id perturbed toward the bag, the perturbed and
    unperturbed log-probs fused by gm_scale, divided by the temperature
    and shifted by the step's Gumbel noise when sampling (the argmax of
    which is the step's token). -> (port (b, V), JAX (b, V)) numpy."""
    jc, tc, jparams, tparams = setup
    b, n = prefix.shape
    size = n - t + kw["max_new_tokens"] + 1      # pplm_generate's cache size
    bow = _bow(bow_ids, tc.padded_vocab_size)
    pkw = dict(stepsize=kw["stepsize"], num_iterations=kw["num_iterations"],
               kl_scale=kw["kl_scale"], window=kw["window"])
    gm, temp = kw["gm_scale"], kw["temperature"]

    tcache = tgpt.init_kv_cache(tc, b, size, torch.float32, device="cpu")
    tgpt.gpt_forward_with_cache(tparams, tc, torch.from_numpy(prefix[:, :-1]).long(),
                                tcache)
    tok = torch.from_numpy(prefix[:, -1:]).long()
    pert = tpplm.perturb_cache(tparams, tc, tcache, tok, torch.from_numpy(bow), **pkw)
    with torch.no_grad():
        tl = (gm * tpplm._next_token_logprobs(tparams, tc, tok, pert)
              + (1.0 - gm) * tpplm._next_token_logprobs(tparams, tc, tok, tcache))

    jcache = jgpt.init_kv_cache(jc, b, size, jnp.float32)
    _, jcache = jgpt.gpt_forward_with_cache(jparams, jc, jnp.asarray(prefix[:, :-1]),
                                            jcache)
    jtok = jnp.asarray(prefix[:, -1:])
    jpert = jpplm.perturb_cache(jparams, jc, jcache, jtok, jnp.asarray(bow), **pkw)
    jl = (gm * jpplm._next_token_logprobs(jparams, jc, jtok, jpert)
          + (1.0 - gm) * jpplm._next_token_logprobs(jparams, jc, jtok, jcache))
    tl, jl = tl.numpy(), np.asarray(jl)
    if temp:
        key = prng.PRNGKey(5)
        for _ in range(t + 1):
            key, sub = prng.split(key)
        noise = prng.gumbel(sub, tl.shape).numpy()
        tl, jl = tl / temp + noise, jl / temp + noise
    return tl, jl


def test_decode_kernels_refuse_operands_that_require_grad():
    """K1, K1-ml and K8 have no backward: their operand checks raise naming
    why when a gradient is asked through an operand (the checks run before
    the CUDA ones, so they are reached here), and pass the operands on to
    the device checks under no_grad."""
    from backpacks_flash_attn_tpu_torch.ops import decode_attention as da
    q = torch.randn(4, 8, requires_grad=True)
    kt, v = torch.randn(4, 8, 16), torch.randn(4, 16, 8)
    i8 = torch.zeros(4, 8, 8, dtype=torch.int8)
    s2 = torch.ones(4, 2, 8)
    calls = [lambda: da._check_operands(q, kt, None, v, None, "decode_attention"),
             lambda: da._lowbit_kernel(q, i8, s2, i8, s2, 5, split_keys=False)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward.*plain_path"):
            call()
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
            call()
    # on a CPU tensor the wrappers take the plain versions, which have one
    out = da.decode_attention(q, kt, None, v, None, 16)
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
