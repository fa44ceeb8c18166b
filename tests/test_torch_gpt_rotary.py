"""A rotary GPT in the port against the JAX package's, on the CPU in f32.

gpt2_test widths (2 layers, d 64, 4 heads of 16, vocab 512) with
``rotary_emb_fraction`` 0.5 (8 rotated channels a head) and no learned
positions (``n_positions`` 0), the same weights in both packages (the JAX
tree carried over with ``params_from_numpy``): the full forward (plain
rotary and XPos), the cached prefill and decode at a scalar length and at
per-slot lengths that differ between rows, and ``generate_gpt``'s greedy
tokens. Then three AdamW steps of a rotary GPT at d 128, where
``fused_mlp.supported`` holds, with the fused-MLP switch on in both
packages (set by monkeypatch), dropout on. Tolerances: 1e-4 on logits (f32
end to end, sums in another order); the training steps to rtol 1e-4 with
atol 1e-6, as the Backpack training test (tests/test_torch_train.py),
except the key biases of the channels past the rotary dim: the softmax
cancels them, their true gradient is 0, and Adam moves them by up to one
lr-sized step on f32 rounding noise, which differs between the packages
(4e-6 at step 2); they are held within the step's lr.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from backpacks_flash_attn_tpu import config as jcfg
from backpacks_flash_attn_tpu.models import gpt as jgpt
from backpacks_flash_attn_tpu.ops import dense as jdense
from backpacks_flash_attn_tpu.training import train as jtrain
from backpacks_flash_attn_tpu.utils import generation as jgen
from backpacks_flash_attn_tpu_torch import config as tcfg
from backpacks_flash_attn_tpu_torch.models import gpt as tgpt
from backpacks_flash_attn_tpu_torch.ops import dense as tdense
from backpacks_flash_attn_tpu_torch.training import train as ttrain
from backpacks_flash_attn_tpu_torch.utils import generation as tgen
from backpacks_flash_attn_tpu_torch.utils import prng
from backpacks_flash_attn_tpu_torch.utils.weights import (params_from_numpy,
                                                         params_to_numpy)

torch.set_num_threads(1)

ATOL_LOGITS = 1e-4
MAX_LEN = 32


def _pair(scale_base=0, n_embd=64):
    """gpt2_test's config with rotary and no learned positions, in both
    packages."""
    kw = dict(vocab_size=512, n_positions=0, n_embd=n_embd, n_head=4,
              n_layer=2, rotary_emb_fraction=0.5,
              rotary_emb_scale_base=scale_base)
    return jcfg.GPTConfig(**kw), tcfg.GPTConfig(**kw)


@pytest.fixture(scope="module")
def setup():
    jc, tc = _pair()
    jparams = jgpt.init_gpt(jc, jax.random.PRNGKey(0))
    # larger embeddings, so that the greedy tokens are far from ties
    jparams["wte"] = jparams["wte"] * 20.0
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jc, tc, jparams, tparams


def _ids(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _close(t, j, atol=ATOL_LOGITS):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("scale_base", [0, 64])        # 64: XPos
def test_rotary_gpt_forward_matches_jax(setup, scale_base):
    _, _, jparams, tparams = setup
    jc, tc = _pair(scale_base)
    assert tc.rotary_emb_dim == jc.rotary_emb_dim == 8
    assert "wpe" not in tparams
    ids = _ids(1, 2, 19)
    jl = jax.jit(lambda p, x: jgpt.gpt_lm_forward(p, jc, x))(jparams, ids)
    tl = tgpt.gpt_lm_forward(tparams, tc, torch.from_numpy(ids).long())
    _close(tl, jl)


@pytest.mark.parametrize("per_slot", [False, True])
def test_rotary_cached_decode_matches_jax(setup, per_slot):
    """A 12-token prefill (the flash branch), then 6 decode steps. Per slot:
    row 1 rolls back to length 9 first, so the rows decode (and rotate) at
    offsets that differ."""
    jc, tc, jparams, tparams = setup
    b, steps = 2, 6
    ids = _ids(2, b, 12 + steps)
    jcache = jgpt.init_kv_cache(jc, b, MAX_LEN, jnp.float32, per_slot=per_slot)
    tcache = tgpt.init_kv_cache(tc, b, MAX_LEN, torch.float32, device="cpu",
                                per_slot=per_slot)
    jstep = jax.jit(lambda c, i: jgpt.gpt_forward_with_cache(jparams, jc, i, c))

    def step(jcache, tcache, x):
        jh, jcache = jstep(jcache, jnp.asarray(x))
        th, tcache = tgpt.gpt_forward_with_cache(
            tparams, tc, torch.from_numpy(x).long(), tcache)
        _close(tgpt.lm_logits(tparams, tc, th),
               jgpt.lm_logits(jparams, jc, jh))
        return jcache, tcache

    jcache, tcache = step(jcache, tcache, ids[:, :12])
    if per_slot:
        lens = np.array([12, 9], np.int32)
        jcache = jcache._replace(length=jnp.asarray(lens))
        tcache.length = torch.from_numpy(lens)
    for t in range(12, 12 + steps):
        jcache, tcache = step(jcache, tcache, ids[:, t:t + 1])
    _close(tcache.k, jcache.k)


def test_generate_gpt_matches_jax(setup):
    jc, tc, jparams, tparams = setup
    ids = _ids(3, 2, 6)
    jseq = jgen.generate_gpt(jparams, jc, jnp.asarray(ids), 20,
                             cache_dtype=jnp.float32).sequences
    tout = tgen.generate_gpt(tparams, tc, torch.from_numpy(ids).long(), 20,
                             cache_dtype=torch.float32, device="cpu",
                             output_scores=True)
    np.testing.assert_array_equal(tout.sequences.numpy(), np.asarray(jseq))
    assert tout.scores.shape == (2, 14, tc.padded_vocab_size)
    with pytest.raises(ValueError, match="no token"):
        tgen.generate_gpt(tparams, tc, torch.from_numpy(ids).long(), 6,
                          device="cpu")


def test_rotary_gpt_train_steps_match_jax_with_fused_mlp(monkeypatch):
    """Three steps (the lr of step 0 is 0 under warmup) of the rotary GPT
    at d 128 with the fused-MLP switch on: JAX's Pallas body in interpret
    mode and K7's plain version in the forward, both backwards recomputing
    from h_pre; loss, gradient norm and every updated parameter."""
    monkeypatch.setattr(jdense, "_FUSED_MLP", True)
    monkeypatch.setattr(tdense, "_FUSED_MLP", True)
    jc, tc = _pair(n_embd=128)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jparams = jgpt.init_gpt(jc, jax.random.PRNGKey(5))
    tparams = ttrain.trainable(params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu"))
    tx = jtrain.make_optimizer(jparams, **opt)
    jstate = jtrain.TrainState(jparams, tx.init(jparams),
                               jnp.zeros((), jnp.int32))
    jstep = jax.jit(jtrain.make_train_step(jc, tx, model="gpt"))
    tstate = ttrain.TrainState(tparams, ttrain.make_optimizer(tparams, **opt), 0)
    tstep = ttrain.make_train_step(tc, model="gpt")
    ids = _ids(4, 2, 17)
    hd = tc.head_dim
    cancelled = [tc.n_embd + h * hd + c for h in range(tc.n_head)
                 for c in range(tc.rotary_emb_dim, hd)]
    for _ in range(3):
        jstate, jm = jstep(jstate, {"input_ids": jnp.asarray(ids)},
                           jax.random.PRNGKey(1))
        tstate, tm = tstep(tstate, {"input_ids": torch.from_numpy(ids).long()},
                           prng.PRNGKey(1))
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[name].item(), float(jm[name]),
                                       rtol=1e-4, err_msg=name)
        want = dict(ttrain.named_leaves(jax.tree.map(np.asarray, jstate.params)))
        got = dict(ttrain.named_leaves(params_to_numpy(tstate.params)))
        assert want.keys() == got.keys()
        bias = ("layers", "Wqkv", "bias")
        for k, v in want.items():
            sel = np.ones(v.shape, bool)
            if k == bias:
                sel[:, cancelled] = False
                np.testing.assert_allclose(got[k][:, cancelled], v[:, cancelled],
                                           rtol=0, atol=opt["lr"])
            np.testing.assert_allclose(got[k][sel], v[sel], rtol=1e-4,
                                       atol=1e-6, err_msg="/".join(k))
