"""The PyTorch port's Backpack model against the JAX package's, on the CPU.

Both packages get the same weights: the JAX tree, made from a seed, crosses
over through ``utils.weights.params_from_numpy``. Sizes are
``backpack_test()`` (2 layers, d = 64, nv = 4, vocab 512). The JAX side
runs as its own tests run it (Pallas in interpret mode on the CPU); its
step functions are jitted so each shape compiles once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu import config as jcfg
from backpacks_flash_attn_tpu.models import backpack as jbp
from backpacks_flash_attn_tpu.models import quantized as jqz
from backpacks_flash_attn_tpu.utils import generation as jgen
from backpacks_flash_attn_tpu_torch import config as tcfg
from backpacks_flash_attn_tpu_torch.models import backpack as tbp
from backpacks_flash_attn_tpu_torch.models import quantized as tqz
from backpacks_flash_attn_tpu_torch.ops import quant as tq
from backpacks_flash_attn_tpu_torch.utils import generation as tgen
from backpacks_flash_attn_tpu_torch.utils.weights import params_from_numpy

torch.set_num_threads(1)

ATOL_LOGITS = 1e-4      # f32 end to end, sums in another order
MAX_LEN = 48


@pytest.fixture(scope="module")
def setup():
    jc, tc = jcfg.backpack_test(), tcfg.backpack_test()
    jparams = jbp.init_backpack(jc, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    tparams = params_from_numpy(np_tree, device="cpu")
    return jc, tc, jparams, tparams


def _ids(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_backpack_forward_and_parts_match_jax(setup):
    jc, tc, jparams, tparams = setup
    ids = _ids(1, 2, 12)
    tids = torch.from_numpy(ids).long()
    jlogits = jax.jit(lambda p, i: jbp.backpack_forward(p, jc, i))(jparams, ids)
    tlogits = tbp.backpack_forward(tparams, tc, tids)
    assert tlogits.shape == (2, 12, tc.padded_vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=ATOL_LOGITS, rtol=0)
    jl, jparts = jax.jit(lambda p, i: jbp.backpack_forward(
        p, jc, i, return_parts=True))(jparams, ids)
    tl, tparts = tbp.backpack_forward(tparams, tc, tids, return_parts=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL_LOGITS,
                               rtol=0)
    for name in ("alpha", "content", "contextual", "outputs"):
        np.testing.assert_allclose(tparts[name].numpy(),
                                   np.asarray(jparts[name]),
                                   atol=ATOL_LOGITS, rtol=0, err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_step(cfg, window):
    return jax.jit(lambda p, i, c: jbp.backpack_forward_with_cache(
        p, cfg, i, c, window=window))


@pytest.mark.parametrize("prompt_len,window", [(5, None), (5, 32),
                                               (12, None), (12, 32)])
def test_cached_prefill_and_decode_match_jax(setup, prompt_len, window):
    """prompt <= 8 takes the flat multi-query branch, > 8 the prefill
    branch; window 32 < MAX_LEN makes every read a window slice."""
    jc, tc, jparams, tparams = setup
    b, steps = 2, 16
    ids = _ids(2, b, prompt_len + steps)
    jcache = jbp.init_backpack_cache(jc, b, MAX_LEN, dtype=jnp.float32)
    tcache = tbp.init_backpack_cache(tc, b, MAX_LEN, torch.float32,
                                     device="cpu")
    step = _jax_step(jc, window)
    pos = prompt_len
    jl, jcache = step(jparams, ids[:, :pos], jcache)
    tl, tcache = tbp.backpack_forward_with_cache(
        tparams, tc, torch.from_numpy(ids[:, :pos]).long(), tcache,
        window=window)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL_LOGITS,
                               rtol=0)
    for _ in range(steps):
        jl, jcache = step(jparams, ids[:, pos:pos + 1], jcache)
        tl, tcache = tbp.backpack_forward_with_cache(
            tparams, tc, torch.from_numpy(ids[:, pos:pos + 1]).long(), tcache,
            window=window)
        pos += 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=ATOL_LOGITS, rtol=0)
    assert tcache.length == int(jcache.length) == prompt_len + steps
    np.testing.assert_allclose(tcache.content.numpy(),
                               np.asarray(jcache.content), atol=ATOL_LOGITS,
                               rtol=0)
    np.testing.assert_allclose(tcache.gpt.k.numpy(), np.asarray(jcache.gpt.k),
                               atol=ATOL_LOGITS, rtol=0)


def test_greedy_generate_matches_jax_and_recompute(setup):
    jc, tc, jparams, tparams = setup
    ids = _ids(3, 2, 5)
    jseq = jgen.generate_backpack(jparams, jc, jnp.asarray(ids), 20,
                                  cache_dtype=jnp.float32).sequences
    tout = tgen.generate_backpack(tparams, tc, torch.from_numpy(ids).long(),
                                  20, cache_dtype=torch.float32, device="cpu",
                                  output_scores=True)
    np.testing.assert_array_equal(tout.sequences.numpy(), np.asarray(jseq))
    assert tout.scores.shape == (2, 15, tc.padded_vocab_size)
    rseq = tgen.generate_backpack_recompute(tparams, tc,
                                            torch.from_numpy(ids).long(), 20)
    np.testing.assert_array_equal(tout.sequences.numpy(), rseq.numpy())


@pytest.fixture(scope="module")
def quantized(setup):
    jc, tc, jparams, tparams = setup
    jq = jqz.quantize_backpack_params(jparams, jc, bits=8)
    tqp = tqz.quantize_backpack_params(tparams, tc, bits=8)
    return jq, tqp


def _quant_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _quant_leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def test_quantize_backpack_params_matches_jax(setup, quantized):
    jq, tqp = quantized
    jleaves = dict(_quant_leaves(jax.tree.map(
        np.asarray, jq, is_leaf=lambda x: x is None)))
    tleaves = dict(_quant_leaves(tqp))
    assert jleaves.keys() == tleaves.keys()
    for path, tl in tleaves.items():
        jl = jleaves[path]
        if path == "/content/table":
            # the table comes from computed senses, whose last-bit f32
            # differences may move a code by one; the quantizer itself is
            # held bit-exact on JAX's table below
            assert np.abs(tl.q.numpy().astype(int)
                          - np.asarray(jl.q).astype(int)).max() <= 1
            np.testing.assert_allclose(tl.scale.numpy(), np.asarray(jl.scale),
                                       rtol=1e-5)
            table = jbp.sense_table(setup[2], setup[0])
            tt = tqz.quantize_sense_table(torch.from_numpy(np.array(table)))
            jt = jqz.quantize_sense_table(table)
            np.testing.assert_array_equal(tt.q.numpy(), np.asarray(jt.q))
            np.testing.assert_allclose(tt.scale.numpy(), np.asarray(jt.scale),
                                       rtol=1e-6, atol=0)
        elif isinstance(tl, tq.QuantWeight):
            np.testing.assert_array_equal(tl.q.numpy(), np.asarray(jl.q),
                                          err_msg=path)
            np.testing.assert_allclose(tl.scale.numpy(), np.asarray(jl.scale),
                                       rtol=1e-6, atol=0, err_msg=path)
            assert (tl.bits, tl.d_out) == (jl.bits, jl.d_out)
        elif tl.dtype == torch.int8:
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl),
                                          err_msg=path)
        else:
            np.testing.assert_allclose(tl.float().numpy(),
                                       np.asarray(jl, np.float32),
                                       rtol=1e-6, atol=0, err_msg=path)


def test_int8_decode_close_to_jax(setup, quantized):
    """INT8 weights (JAX's, carried across bit for bit) + INT8 caches,
    teacher-forced: both run bf16 activations, so logits agree to
    1e-2 of their largest magnitude."""
    jc, tc, _, _ = setup
    jq, _ = quantized
    tqp = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    b, prompt_len, steps = 2, 12, 8
    ids = _ids(4, b, prompt_len + steps)
    jcache = jbp.init_backpack_cache(jc, b, MAX_LEN, dtype=jnp.int8)
    tcache = tbp.init_backpack_cache(tc, b, MAX_LEN, torch.int8, device="cpu")
    step = _jax_step(jc, None)
    pos = prompt_len
    chunks = [ids[:, :pos]] + [ids[:, p:p + 1] for p in range(pos, pos + steps)]
    for chunk in chunks:
        jl, jcache = step(jq, chunk, jcache)
        tl, tcache = tbp.backpack_forward_with_cache(
            tqp, tc, torch.from_numpy(chunk).long(), tcache)
        assert tl.dtype == torch.float32
        jl = np.asarray(jl)
        assert np.abs(tl.numpy() - jl).max() <= 1e-2 * np.abs(jl).max()
