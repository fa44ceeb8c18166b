"""The port's low-bit caches and quantization gates against the JAX
package's, on the CPU.

``backpack_test()`` weights (2 layers, d = 64, nv = 4, vocab 512) cross
over through ``params_from_numpy``. The four cache configurations of the
JAX package's tests (tests/models/test_backpack.py:120), as (bits,
kv_bits): (4, None) full low-bit, (4, 8) int4 senses with INT8 KV, (8, 4)
INT8 senses with int4 KV, (8, None) INT8. f32 weights and activations.

Tolerances. Logits: 1e-3 of the largest logit magnitude. Both packages
quantize the same f32 activations, but XLA's and torch's last bits differ,
and a value that lands on a rounding boundary takes the neighbouring code
in one of them; one code moves a logit by far less than that bound, a
wrong cache position or parity by far more. Caches: compared dequantized,
within one quantization step (the larger of the two scales) at every
valid position, for the same reason. The gates: both packages run the
quantized trees in bf16, and their logits differ by one bf16 ulp (the
quantized weights are bit-equal), so perplexities agree within 1e-3
relative (6e-4 measured) and the deltas, differences of two of them,
within twice that of the fp perplexity; the gates' verdicts are equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu import config as jcfg
from backpacks_flash_attn_tpu.eval import quant_gates as jgates
from backpacks_flash_attn_tpu.models import backpack as jbp
from backpacks_flash_attn_tpu_torch import config as tcfg
from backpacks_flash_attn_tpu_torch.eval import quant_gates as tgates
from backpacks_flash_attn_tpu_torch.models import backpack as tbp
from backpacks_flash_attn_tpu_torch.ops import quant as tq
from backpacks_flash_attn_tpu_torch.utils.weights import params_from_numpy

torch.set_num_threads(1)

MAX_LEN = 24
CONFIGS = [(4, None), (4, 8), (8, 4), (8, None)]
LOGIT_RTOL = 1e-3
PPL_RTOL = 1e-3


@pytest.fixture(scope="module")
def setup():
    jc, tc = jcfg.backpack_test(), tcfg.backpack_test()
    jparams = jbp.init_backpack(jc, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jc, tc, jparams, tparams


def _ids(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _jax_step(cfg, window):
    return jax.jit(lambda p, i, c: jbp.backpack_forward_with_cache(
        p, cfg, i, c, window=window))


def _close(tl, jl):
    jl = np.asarray(jl)
    err = np.abs(tl.numpy() - jl).max()
    assert err <= LOGIT_RTOL * np.abs(jl).max(), (err, np.abs(jl).max())


def _deq(q, scale, bits, axis):
    """(values, per-position scales) of one cache tensor as float64 numpy,
    positions on ``axis``; int4 and split int8 tensors come back
    interleaved."""
    q, scale = torch.from_numpy(np.array(q)), torch.from_numpy(np.array(scale))
    if bits == 4:
        if q.dim() == 4:            # split int8 keys (E, d, 2, S/2)
            vals = q.transpose(2, 3).reshape(q.shape[0], q.shape[1], -1)
        else:
            vals = tq.unpack_int4_pairs(q, axis)
        scale = tq.interleave_pair_scales(scale)
    else:
        vals = q
    sc = scale[:, None, :] if axis == 2 else scale[..., None]
    return (vals.double() * sc.double()).numpy(), sc.double().numpy()


def _cache_within_one_step(tensors, length):
    """tensors: (name, port q, port scale, JAX q, JAX scale, bits, axis)."""
    for name, tqv, tsc, jqv, jsc, bits, axis in tensors:
        tv, ts = _deq(tqv, tsc, bits, axis)
        jv, js = _deq(jqv, jsc, bits, axis)
        sl = [slice(None)] * tv.ndim
        sl[axis] = slice(0, length)
        sl = tuple(sl)
        step = np.maximum(np.broadcast_to(ts, tv.shape),
                          np.broadcast_to(js, jv.shape))[sl]
        err = np.abs(tv[sl] - jv[sl])
        assert (err <= step * 1.0001 + 1e-9).all(), (name, err.max())


def _caches(tcache, jcache):
    g, jg = tcache.gpt, jcache.gpt
    gbits, bits = g.bits, tcache.bits
    out = []
    for li in range(g.k.shape[0]):
        out += [(f"gpt.k[{li}]", g.k[li], g.k_scale[li], jg.k[li],
                 jg.k_scale[li], gbits, 2),
                (f"gpt.v[{li}]", g.v[li], g.v_scale[li], jg.v[li],
                 jg.v_scale[li], gbits, 1)]
    return out + [("ctx_k", tcache.ctx_k, tcache.ctx_k_scale, jcache.ctx_k,
                   jcache.ctx_k_scale, bits, 2),
                  ("content", tcache.content, tcache.content_scale,
                   jcache.content, jcache.content_scale, bits, 1)]


@pytest.mark.parametrize("bits,kv_bits", CONFIGS)
def test_lowbit_cached_decode_matches_jax(setup, bits, kv_bits):
    """Prefill 8, a continuation of 8 at the even offset 8 (the prefill
    branch over the dequantized prefix for int4 caches, the flat
    multi-query branch for INT8), then 4 decode steps under a 20-position
    window (K8's plain version for int4 caches)."""
    jc, tc, jparams, tparams = setup
    b = 2
    ids = _ids(7, b, 20)
    jcache = jbp.init_backpack_cache(jc, b, MAX_LEN, dtype=jnp.int8,
                                     bits=bits, kv_bits=kv_bits)
    tcache = tbp.init_backpack_cache(tc, b, MAX_LEN, torch.int8, device="cpu",
                                     bits=bits, kv_bits=kv_bits)
    assert (tcache.bits, tcache.gpt.bits) == (jcache.bits, jcache.gpt.bits)
    assert (tcache.bits, tcache.gpt.bits) == (bits, kv_bits or bits)
    for name, t, j in (("ctx_k", tcache.ctx_k, jcache.ctx_k),
                       ("content", tcache.content, jcache.content),
                       ("content_scale", tcache.content_scale,
                        jcache.content_scale),
                       ("gpt.k", tcache.gpt.k, jcache.gpt.k),
                       ("gpt.v_scale", tcache.gpt.v_scale,
                        jcache.gpt.v_scale)):
        assert tuple(t.shape) == j.shape, name
    chunks = [(0, 8, None), (8, 16, None)] + [(p, p + 1, 20)
                                              for p in range(16, 20)]
    for start, stop, window in chunks:
        jl, jcache = _jax_step(jc, window)(jparams, ids[:, start:stop], jcache)
        tl, tcache = tbp.backpack_forward_with_cache(
            tparams, tc, torch.from_numpy(ids[:, start:stop]).long(), tcache,
            window=window)
        _close(tl, jl)
        if stop == 8:
            _cache_within_one_step(_caches(tcache, jcache), 8)
    assert tcache.length == int(jcache.length) == 20
    _cache_within_one_step(_caches(tcache, jcache), 20)


@pytest.mark.parametrize("bits,kv_bits", [(4, None), (8, 4)])
def test_lowbit_odd_prefill_then_decode_matches_jax(setup, bits, kv_bits):
    """An odd prefill (7) leaves the last high nibble zero with a 1.0
    scale; the next decode step's nibble read-modify-write fills it."""
    jc, tc, jparams, tparams = setup
    ids = _ids(8, 2, 11)
    jcache = jbp.init_backpack_cache(jc, 2, MAX_LEN, dtype=jnp.int8,
                                     bits=bits, kv_bits=kv_bits)
    tcache = tbp.init_backpack_cache(tc, 2, MAX_LEN, torch.int8, device="cpu",
                                     bits=bits, kv_bits=kv_bits)
    for start, stop in [(0, 7)] + [(p, p + 1) for p in range(7, 11)]:
        jl, jcache = _jax_step(jc, None)(jparams, ids[:, start:stop], jcache)
        tl, tcache = tbp.backpack_forward_with_cache(
            tparams, tc, torch.from_numpy(ids[:, start:stop]).long(), tcache)
        _close(tl, jl)
        if stop == 7:
            assert (tcache.gpt.k_scale[:, :, 1, 3] == 1.0).all()
            assert (tq.unpack_int4_pairs_split(tcache.gpt.k[..., 3])[1]
                    == 0).all()
    _cache_within_one_step(_caches(tcache, jcache), 11)


def test_lowbit_cache_rejects_odd_offset_writes(setup):
    _, tc, _, tparams = setup
    cache = tbp.init_backpack_cache(tc, 1, MAX_LEN, torch.int8, device="cpu",
                                    bits=4)
    ids = torch.from_numpy(_ids(9, 1, 9)).long()
    _, cache = tbp.backpack_forward_with_cache(tparams, tc, ids[:, :5], cache)
    with pytest.raises(ValueError, match="even length"):
        tbp.backpack_forward_with_cache(tparams, tc, ids[:, 5:9], cache)
    with pytest.raises(ValueError, match="even max_seqlen"):
        tbp.init_backpack_cache(tc, 1, 23, torch.int8, device="cpu", bits=4)


# ---------------------------------------------------------------- gates

SEQLEN, BATCH, MAX_BATCHES = 16, 2, 2


@pytest.fixture(scope="module")
def gate_setup():
    """Weights whose logits are O(1) (wte and the sense network's output
    layer scaled up), so that the deltas the gates read (0.3 to 16 ppl)
    stand well above bf16 rounding; a tiny corpus."""
    jc, tc = jcfg.backpack_test(), tcfg.backpack_test()
    jparams = jbp.init_backpack(jc, jax.random.PRNGKey(1))
    jparams["gpt"]["wte"] = jparams["gpt"]["wte"] * 20.0
    fc2 = jparams["content"]["final_mlp"]["fc2"]
    fc2["kernel"] = fc2["kernel"] * 20.0
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    tokens = _ids(10, 1, 120)[0]
    return jc, tc, jparams, tparams, tokens


def _gates_close(tout, jout):
    assert tout.keys() == jout.keys()
    delta_atol = 2 * PPL_RTOL * jout["bf16_ppl"]
    for k, jv in jout.items():
        tv = tout[k]
        if isinstance(jv, bool):
            assert tv == jv, k
        elif k.endswith("_ppl"):
            np.testing.assert_allclose(tv, jv, rtol=PPL_RTOL, err_msg=k)
        elif k.endswith("_delta"):
            np.testing.assert_allclose(tv, jv, rtol=0, atol=delta_atol,
                                       err_msg=k)
        else:
            assert tv == jv, k


def test_run_cache_gates_matches_jax(gate_setup):
    jc, tc, jparams, tparams, tokens = gate_setup
    kw = dict(batch_size=BATCH, max_batches=MAX_BATCHES)
    jout = jgates.run_cache_gates(jparams, jc, tokens, SEQLEN, **kw)
    tout = tgates.run_cache_gates(tparams, tc, tokens, SEQLEN, device="cpu",
                                  **kw)
    _gates_close(tout, jout)
    assert all(np.isfinite(v) for v in tout.values())


def test_run_gates_matches_jax(gate_setup):
    jc, tc, jparams, tparams, tokens = gate_setup
    kw = dict(batch_size=BATCH, max_batches=MAX_BATCHES)
    jout = jgates.run_gates(jparams, jc, tokens, SEQLEN, **kw)
    tout = tgates.run_gates(tparams, tc, tokens, SEQLEN, device="cpu", **kw)
    _gates_close(tout, jout)


def test_quant_gates_cli_on_a_training_workdir(tmp_path):
    """The CLI on the newest checkpoint of a 2-step run of the training CLI
    (backpack-test, CPU), and on the same weights exported to a reference
    Lightning checkpoint through --checkpoint."""
    import json
    from contextlib import redirect_stdout
    from io import StringIO

    from backpacks_flash_attn_tpu_torch.data import lm_dataset as lmd
    from backpacks_flash_attn_tpu_torch.training import train_cli

    corpus = lmd.save_corpus(_ids(11, 1, 3000)[0].astype(np.uint16),
                             str(tmp_path), "c")
    workdir = str(tmp_path / "run")
    train_cli.run(train_cli.RunConfig(
        corpus=corpus, workdir=workdir, model="backpack-test", steps=2,
        batch_size=2, seqlen=16, warmup_steps=1, log_every=1, device="cpu"))
    buf = StringIO()
    with redirect_stdout(buf):
        tgates.main(["--workdir", workdir, "--corpus", corpus, "--model",
                     "backpack-test", "--seqlen", "16", "--max-batches", "1",
                     "--val-fraction", "0.05", "--device", "cpu"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["checkpoint_step"] == 2
    for key in ("int8_delta", "int4_delta", "int4_cache_delta",
                "int8_senses_int4_kv_delta"):
        assert np.isfinite(out[key]), key
    # --checkpoint: a reference-format Lightning file of the trained weights
    from backpacks_flash_attn_tpu_torch.training import checkpoint as ckpt_lib
    from backpacks_flash_attn_tpu_torch.utils import torch_import
    tc = tcfg.backpack_test()
    _, kind, params0 = train_cli.build_model(train_cli.RunConfig(
        corpus=corpus, workdir=workdir, model="backpack-test", device="cpu"),
        torch.device("cpu"))
    restored, _, _ = ckpt_lib.restore(ckpt_lib.latest_checkpoint(workdir),
                                      {"state": {"params": params0}})
    sd = torch_import.state_dict_from_backpack_params(
        restored["state"]["params"], tc)
    path = str(tmp_path / "last.ckpt")
    torch.save({"state_dict": {"model." + k: torch.from_numpy(v)
                               for k, v in sd.items()}}, path)
    buf = StringIO()
    with redirect_stdout(buf):
        tgates.main(["--checkpoint", path, "--corpus", corpus, "--model",
                     "backpack-test", "--seqlen", "16", "--max-batches", "1",
                     "--val-fraction", "0.05", "--device", "cpu"])
    imported = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert imported["checkpoint_step"] == -1 and kind == "backpack"
    # the same bf16 weights either way: the same numbers
    assert {k: v for k, v in imported.items() if k != "checkpoint_step"} == \
        {k: v for k, v in out.items() if k != "checkpoint_step"}
