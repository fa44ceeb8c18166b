"""The port's tensor-parallel serving (parallel/tp_decode.py,
parallel/serving.py, the ('data', 'model') mesh and its specs in
parallel/mesh.py) against the JAX package's, on the CPU.

The world side: one gloo world of 4 processes (``parallel/launch.py``; the
ranks' side in tests/torch_parallel_ranks.py, which imports no JAX) runs
every case at (data 2, model 2) and each test compares one case with JAX's
UNSHARDED ``backpack_forward_with_cache`` (jitted, use_flash=False), the
oracle of JAX's own tests/parallel/test_tp_decode.py: the same weights
(numpy draws from a seed, through ``params_from_numpy``), the same
prefilled cache and tokens. Tolerance: JAX's own there, rtol = atol = 2e-3
on the logits and the final cache, greedy tokens equal; the caches of the
INT8- and INT4-weight cases, whose activations are bf16, to KEY_ATOL on
their (dequantized) entries. The in-process
side holds the permute, the cache conversions and the spec trees equal to
JAX's exactly, content_forward(embedded=) to 1e-5 (f32) and ring_psum over
a ring of one.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from backpacks_flash_attn_tpu import config as jcfg
from backpacks_flash_attn_tpu.models import backpack as jbp
from backpacks_flash_attn_tpu.models import quantized as jqz
from backpacks_flash_attn_tpu.parallel import mesh as jmesh
from backpacks_flash_attn_tpu.parallel import tp_decode as jtp
from backpacks_flash_attn_tpu_torch import config as tcfg
from backpacks_flash_attn_tpu_torch.models import backpack as tbp
from backpacks_flash_attn_tpu_torch.parallel import launch
from backpacks_flash_attn_tpu_torch.parallel import mesh as tmesh
from backpacks_flash_attn_tpu_torch.parallel import tp_decode as ttp
from backpacks_flash_attn_tpu_torch.utils.weights import params_from_numpy

import torch_parallel_ranks as ranks_lib

torch.set_num_threads(1)

RANKS = str(Path(__file__).with_name("torch_parallel_ranks.py")) + ":run_cases"
RTOL = ATOL = 2e-3
KEY_ATOL = 1e-2
B, PROMPT, MAX_LEN, STEPS = 4, 5, 16, 4
SLOT_LENS, WINDOW, SLOT_STEPS = (2, 5, 3, 4), 8, 3
DATA, MODEL = 2, 2
CFG = dict(vocab_size=512, n_positions=128, n_embd=64, n_head=4, n_layer=2,
           num_senses=4, scale_attn_by_inverse_layer_idx=True,
           pad_vocab_size_multiple=8)


def _np_params():
    """backpack_test()'s tree, every leaf drawn from one numpy seed: the
    LayerNorm weights 1 + N(0, 0.1), everything else N(0, 0.02) (non-zero
    biases, so that each bias's place in the sharded sums shows)."""
    rng = np.random.default_rng(0)
    tree = tbp.init_backpack(tcfg.backpack_test(), torch.Generator().manual_seed(0),
                             device="cpu")

    def draw(t, path):
        if isinstance(t, dict):
            return {k: draw(v, path + (k,)) for k, v in t.items()}
        x = rng.standard_normal(tuple(t.shape))
        ln = path[-1] == "weight"
        return (1 + 0.1 * x if ln else 0.02 * x).astype(np.float32)
    return draw(tree, ())


def jax_cache_numpy(c):
    """A JAX BackpackCache as ranks_lib.cache_from_numpy's arrays."""
    a = lambda x: None if x is None else np.asarray(x)
    return dict(k=a(c.gpt.k), v=a(c.gpt.v), k_scale=a(c.gpt.k_scale),
                v_scale=a(c.gpt.v_scale), gpt_length=a(c.gpt.length),
                ctx_k=a(c.ctx_k), content=a(c.content), ctx_k_scale=a(c.ctx_k_scale),
                content_scale=a(c.content_scale), length=a(c.length))


def _greedy(logits):
    return np.asarray(jnp.argmax(logits[:, -1], -1)[:, None], np.int32)


@pytest.fixture(scope="module")
def jax_side():
    """JAX's unsharded decode of every case: the prefilled cache, the tokens
    each step is fed (the oracle's greedy choice) and its logits, and its
    cache after the last step."""
    jc = jcfg.BackpackConfig(**CFG)
    np_params = _np_params()
    jparams = jax.tree.map(jnp.asarray, np_params)
    q8 = jax.jit(lambda p: jqz.quantize_backpack_params(p, jc, bits=8))(jparams)
    q4 = jax.jit(lambda p: jqz.quantize_backpack_params(p, jc, bits=4))(jparams)
    ids = np.random.default_rng(1).integers(0, jc.vocab_size, (B, PROMPT)).astype(np.int32)
    out = {"np_params": np_params, "q8": jax.tree.map(np.asarray, q8),
           "q4": jax.tree.map(np.asarray, q4)}
    for name, params, dtype, steps in (("f32", jparams, jnp.float32, STEPS),
                                       ("int8", jparams, jnp.int8, STEPS),
                                       ("int8w", q8, jnp.int8, STEPS - 1),
                                       ("int4w", q4, jnp.float32, STEPS)):
        cache = jax.jit(lambda: jbp.init_backpack_cache(jc, B, MAX_LEN, dtype=dtype))()
        step = jax.jit(lambda p, i, c: jbp.backpack_forward_with_cache(
            p, jc, i, c, use_flash=False))
        logits, cache = step(params, ids, cache)
        case = {"cache": jax_cache_numpy(cache), "prefill": np.asarray(logits),
                "tokens": [], "logits": []}
        tok = _greedy(logits)
        for _ in range(steps):
            case["tokens"].append(tok)
            logits, cache = step(params, tok, cache)
            case["logits"].append(np.asarray(logits))
            tok = _greedy(logits)
        case["next"], case["final"] = tok, jax_cache_numpy(cache)
        out[name] = case
    # per-slot lengths with a window: the f32 prefill's cache, each slot
    # read to its own length (the columns past it are stale, as a retired
    # slot leaves them), fed the prefill's token at its own last position
    f32 = out["f32"]
    lens = np.asarray(SLOT_LENS, np.int32)
    c = jax.tree.map(jnp.asarray, f32["cache"])
    cache = jbp.BackpackCache(
        gpt=jbp.gpt_lib.KVCache(k=c["k"], v=c["v"], length=jnp.asarray(lens)),
        ctx_k=c["ctx_k"], content=c["content"], length=jnp.asarray(lens))
    step = jax.jit(lambda p, i, c: jbp.backpack_forward_with_cache(
        p, jc, i, c, use_flash=False, window=WINDOW))
    case = {"cache": jax_cache_numpy(cache), "tokens": [], "logits": []}
    tok = np.argmax(f32["prefill"][np.arange(B), lens - 1], -1)[:, None].astype(np.int32)
    for _ in range(SLOT_STEPS):
        case["tokens"].append(tok)
        logits, cache = step(jparams, tok, cache)
        case["logits"].append(np.asarray(logits))
        tok = _greedy(logits)
    case["final"] = jax_cache_numpy(cache)
    out["slots"] = case
    return out


def _case(jax_side, name, entry, source=None, params="np_params", **kw):
    src = jax_side[source or name]
    return dict(kind="tp", entry=entry, cfg=CFG, data=DATA, model=MODEL,
                params=jax_side[params], cache=src["cache"], tokens=src["tokens"], **kw)


@pytest.fixture(scope="module")
def port(jax_side):
    """Every case on one world of 4 ranks at (data 2, model 2); rank 0's
    results (every rank's logits agree: each holds the whole after the
    gathers)."""
    cases = {
        "f32": _case(jax_side, "f32", "step"),
        "int8": _case(jax_side, "int8", "step"),
        "int8w": _case(jax_side, "int8w", "step", params="q8"),
        "slots": _case(jax_side, "slots", "step", window=WINDOW),
        "one_microbatch": _case(jax_side, "one_microbatch", "step", source="f32",
                                microbatches=1),
        "scan": _case(jax_side, "scan", "scan", source="f32", steps=STEPS),
        "serving": _case(jax_side, "serving", "serving", source="f32", tp_params=False),
        "serving_tp": _case(jax_side, "serving_tp", "serving", source="f32",
                            tp_params=True),
        "int4": _case(jax_side, "int4", "int4", source="int4w", params="q4"),
        "refusals": _case(jax_side, "refusals", "refusals", source="f32"),
    }
    ranks = launch.run_world(RANKS, DATA * MODEL, args=(list(cases.values()),),
                             threads=1, timeout=600)
    out = {}
    for i, name in enumerate(cases):
        out[name] = ranks[0][i]
        for r in ranks[1:]:
            for k in ("logits", "tokens"):
                if k in out[name]:
                    np.testing.assert_array_equal(np.asarray(r[i][k]),
                                                  np.asarray(out[name][k]), err_msg=name)
    out["ranks"] = ranks
    return out


def _check_steps(got, want, name):
    assert len(got["logits"]) == len(want["logits"])
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"{name} step {i}")
        np.testing.assert_array_equal(g[:, -1].argmax(-1), w[:, -1].argmax(-1),
                                      err_msg=f"{name} step {i}")


def _check_cache(got, want, name):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if w is None:
            assert got[k] is None, (name, k)
            continue
        np.testing.assert_allclose(np.asarray(got[k], np.float32), np.asarray(w, np.float32),
                                   rtol=RTOL, atol=ATOL, err_msg=f"{name} {k}")


@pytest.mark.parametrize("name,source", [("f32", "f32"), ("int8", "int8"),
                                         ("int8w", "int8w"), ("slots", "slots"),
                                         ("one_microbatch", "f32")])
def test_tp_decode_matches_unsharded(jax_side, port, name, source):
    """The TP step, teacher-forced on the oracle's greedy tokens: the f32
    and INT8 caches, INT8 weights (the INT8 sense table sense-sharded, the
    tied head from the INT8 wte shard) against JAX's quantized step, per-slot
    lengths under a window bucket, and the single-microbatch schedule; then
    the updated cache, converted back with from_tp_cache."""
    _check_steps(port[name], jax_side[source], name)
    want = jax_side[source]["final"]
    if name != "int8w":
        _check_cache(port[name]["cache"], want, name)
        return
    # INT8 weights run bf16 activations, whose rounding differs between the
    # sharded and the unsharded sums (a bf16 ulp at 0.5 is 2^-9): the
    # dequantized keys and values (codes times scales) agree to KEY_ATOL
    # (read 5.3e-3 at entries up to 0.59), while their codes may part by a
    # few units and their scales by a bf16 ulp; the senses, gathered from
    # the table, exactly
    got = port[name]["cache"]
    np.testing.assert_array_equal(got["content"], want["content"])
    np.testing.assert_array_equal(got["content_scale"], want["content_scale"])
    for key, sc, axis in (("k", "k_scale", 2), ("v", "v_scale", 3), ("ctx_k", "ctx_k_scale", 1)):
        deq = lambda c: c[key].astype(np.float32) * np.expand_dims(c[sc], axis)
        np.testing.assert_allclose(deq(got), deq(want), rtol=0, atol=KEY_ATOL, err_msg=key)


def test_tp_decode_scan_matches_unsharded_greedy(jax_side, port):
    """make_tp_decode_scan's 4 greedy steps from the first token: its last
    token and its cache (which holds every token's keys and senses) equal
    the oracle's greedy decode's; with donate=False the same token, the
    caller's cache left as it was."""
    np.testing.assert_array_equal(port["scan"]["tokens"], jax_side["f32"]["next"])
    np.testing.assert_array_equal(port["scan"]["donate_false_tokens"],
                                  jax_side["f32"]["next"])
    assert port["scan"]["donate_false_kept_cache"]
    _check_cache(port["scan"]["cache"], jax_side["f32"]["final"], "scan")


@pytest.mark.parametrize("name", ["serving", "serving_tp"])
def test_sharded_decode_step_matches_unsharded(jax_side, port, name):
    """make_sharded_decode_step: slots over 'data', params replicated or
    (tp_params) kept as this rank's 'model' slices and gathered each step,
    which hold about half the bytes at model 2."""
    _check_steps(port[name], jax_side["f32"], name)
    _check_cache(port[name]["cache"], jax_side["f32"]["final"], name)
    got = port[name]
    if name == "serving_tp":
        assert got["local_bytes"] < 0.6 * got["bytes"], (got["local_bytes"], got["bytes"])
    else:
        assert got["local_bytes"] == got["bytes"]


def test_sharded_decode_step_int4_and_refusals(jax_side, port):
    """An INT4 tree (JAX's quantizer), which tp_decode refuses, through
    serving's tp_params path against JAX's unsharded INT4 step: logits and
    the final cache at rtol = atol = 2e-3, greedy tokens equal; and, as a
    round trip of shard_params / gather_params, equal to 1e-6 to the
    port's single-device step on the same tree on each rank. The refusals
    of tp_decode (JAX's asserts) raise before any collective."""
    got = port["int4"]
    _check_steps(got, jax_side["int4w"], "int4")
    # the cache holds bf16 activations (INT4 trees compute in bf16), which
    # round apart where the two packages' sums differ in order: entries to
    # KEY_ATOL (read 3.9e-3 on k, 2.9e-3 on ctx_k, 2.0e-3 on v; the senses
    # and the lengths exactly)
    want = jax_side["int4w"]["final"]
    assert got["cache"].keys() == want.keys()
    for k, w in want.items():
        if w is None:
            assert got["cache"][k] is None, k
            continue
        np.testing.assert_allclose(np.asarray(got["cache"][k], np.float32),
                                   np.asarray(w, np.float32), rtol=0, atol=KEY_ATOL,
                                   err_msg=f"int4 {k}")
    assert max(got["diffs"]) <= 1e-6, got["diffs"]
    assert got["local_bytes"] < 0.6 * got["bytes"]
    msg = port["refusals"]
    assert "n_head" in msg["heads"] and "padded vocabulary" in msg["vocab"]
    assert "attn_dwconv" in msg["dwconv"] and "microbatches" in msg["microbatches"]
    assert "per-channel INT8" in msg["int4"] and "per-channel INT8" in msg["grouped"]


# ------------------------------------------------------------ in process

def _canon(x):
    """A spec or parameter tree of either package in one form: specs as
    tuples, dataclasses and NamedTuples as dicts of their fields, arrays
    as numpy."""
    if isinstance(x, PartitionSpec):
        return ("spec", tuple(x))
    if isinstance(x, tuple) and not hasattr(x, "_fields"):
        return ("spec", x)
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return {"type": type(x).__name__, **{k: _canon(getattr(x, k)) for k in x._fields}}
    if dataclasses.is_dataclass(x):
        return {"type": type(x).__name__,
                **{f.name: _canon(getattr(x, f.name)) for f in dataclasses.fields(x)}}
    if isinstance(x, torch.Tensor):       # bf16 leaves as (exact) f32
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if isinstance(x, (jax.Array, np.ndarray)):
        a = np.asarray(x)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return x


def _assert_same(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), (path, a, b)
        for k in b:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


@pytest.fixture(scope="module")
def trees(jax_side):
    jc = jcfg.BackpackConfig(**CFG)
    tc = tcfg.BackpackConfig(**CFG)
    jf = jax.tree.map(jnp.asarray, jax_side["np_params"])
    jq = jax.tree.map(jnp.asarray, jax_side["q8"])
    return dict(jc=jc, tc=tc, jax={"f32": jf, "int8": jq},
                port={"f32": params_from_numpy(jax_side["np_params"], device="cpu"),
                      "int8": params_from_numpy(jax_side["q8"], device="cpu")})


def test_permute_and_specs_match_jax(trees):
    """permute_for_tp_decode (Wqkv to (h, 3, dh), the ctx Wqkv to (nv, 2,
    dnv), the INT8 pads stripped, lm_head dropped) bit-equal to JAX's; its
    spec tree, the Megatron specs and _match_spec_to_params over the f32 and
    the INT8 trees equal to JAX's PartitionSpec trees read as tuples."""
    jc, tc = trees["jc"], trees["tc"]
    _assert_same(_canon(jmesh.backpack_param_specs(jc)),
                 _canon(tmesh.backpack_param_specs(tc)))
    _assert_same(_canon(jmesh.gpt_param_specs(jc)), _canon(tmesh.gpt_param_specs(tc)))
    permute = jax.jit(lambda p: jtp.permute_for_tp_decode(p, jc))
    for kind in ("f32", "int8"):
        jp, tp = trees["jax"][kind], trees["port"][kind]
        _assert_same(_canon(ttp.permute_for_tp_decode(tp, tc)),
                     _canon(jax.device_get(permute(jp))))
        _assert_same(_canon(ttp.tp_decode_param_specs(ttp.permute_for_tp_decode(tp, tc))),
                     _canon(jtp.tp_decode_param_specs(permute(jp))))
        _assert_same(_canon(tmesh.param_specs(tp, tc)),
                     _canon(jmesh._match_spec_to_params(jp, jmesh.backpack_param_specs(jc))))
    with pytest.raises(NotImplementedError, match="7b"):
        tmesh.gpt_param_specs(tcfg.BackpackConfig(**dict(CFG, moe_experts=4)))


def test_tp_cache_conversions_match_jax(jax_side, trees):
    """to_tp_cache and tp_cache_specs equal to JAX's on the INT8 cache (a
    scalar length) and the per-slot cache; from_tp_cache gives the flat
    cache back exactly."""
    jc, tc = trees["jc"], trees["tc"]
    to_tp = jax.jit(lambda c: jtp.to_tp_cache(c, jc))
    for name in ("int8", "slots"):
        arrays = jax_side[name]["cache"]
        jcache = jbp.BackpackCache(
            gpt=jbp.gpt_lib.KVCache(k=arrays["k"], v=arrays["v"],
                                    length=arrays["gpt_length"],
                                    k_scale=arrays["k_scale"], v_scale=arrays["v_scale"]),
            ctx_k=arrays["ctx_k"], content=arrays["content"], length=arrays["length"],
            content_scale=arrays["content_scale"], ctx_k_scale=arrays["ctx_k_scale"])
        jt = jax.device_get(to_tp(jax.tree.map(jnp.asarray, jcache)))
        tt = ttp.to_tp_cache(ranks_lib.cache_from_numpy(arrays), tc)
        want = _canon(jt)
        got = _canon(tt)
        got["type"] = want["type"]
        if np.ndim(arrays["length"]) == 0:
            got["length"] = np.asarray(got["length"], want["length"].dtype)
        _assert_same(got, want)
        specs = _canon(ttp.tp_cache_specs(tt))
        specs["type"] = "TPDecodeCache"
        _assert_same(specs, _canon(jtp.tp_cache_specs(jt)))
        back = ranks_lib.cache_to_numpy(ttp.from_tp_cache(tt, tc))
        for k, v in arrays.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k) if v is not None else None


def test_content_forward_embedded_matches_jax(trees):
    """content_forward(embedded=) runs the sense network on the given rows
    (JAX :107), f32 to 1e-5; a sense table ignores them."""
    jc, tc = trees["jc"], trees["tc"]
    ids = np.random.default_rng(3).integers(0, 512, (2, 3)).astype(np.int32)
    emb = (np.random.default_rng(4).standard_normal((2, 3, 64)) * 0.1).astype(np.float32)
    want = jax.jit(lambda p, i, e: jbp.content_forward(p, jc, i, embedded=e))(
        trees["jax"]["f32"], ids, emb)
    got = tbp.content_forward(trees["port"]["f32"], tc, torch.from_numpy(ids).long(),
                              embedded=torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    q8, tid = trees["port"]["int8"], torch.from_numpy(ids).long()
    torch.testing.assert_close(
        tbp.content_forward(q8, tc, tid, embedded=torch.from_numpy(emb)),
        tbp.content_forward(q8, tc, tid), rtol=0, atol=0)


def test_ring_psum_ring_of_one():
    """A ring of one rank: the input back, the overlap thunk run once."""
    ring = tmesh.Ring(group=None, rank=0, size=1, nxt=0, prv=0)
    x = torch.randn(3, 1, 8)
    calls = []
    out, ov = ttp.ring_psum(x, ring, overlap=lambda: calls.append(1) or "done")
    assert out is x and ov == "done" and calls == [1]
    assert ttp.ring_psum(x, ring) == (x, None)
