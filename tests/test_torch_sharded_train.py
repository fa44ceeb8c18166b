"""The port's sharded training (training/train.py's make_sharded_train_step,
ZeRO-1/2/3, vocab_parallel_cross_entropy, remat, gradient accumulation and
the training CLI's --dp/--tp/--zero*) against the JAX package's, on the CPU.

The world side is one gloo world of 4 processes at mesh (data 2, model 2)
(``parallel/launch.py``; the ranks run tests/torch_parallel_ranks.py,
which imports no JAX), with JAX's weights carried over by
``params_from_numpy``. The oracle is JAX's unsharded ``make_train_step``,
jitted, with its flash attention: the port's attention dropout is the
flash kernels' counter hash, which JAX's ``use_flash=False`` path (a
``jax.random.bernoulli`` mask) does not draw. Three steps at dropout 0.1
(the config's default), JAX's own tolerances (tests/parallel/
test_parallel.py:77-80): the loss to rtol 1e-5, the gradient norm to rtol
1e-4; the parameters and AdamW's first moments after the last step to rtol
1e-4 with atol 1e-6 and 1e-8 (the key biases' true gradient is 0, and Adam
moves them on f32 rounding noise; 1e-6 is 0.1% of a step's update here).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from backpacks_flash_attn_tpu.config import BackpackConfig, GPTConfig, backpack_test
from backpacks_flash_attn_tpu.models import backpack as jbp
from backpacks_flash_attn_tpu.models import gpt as jgpt
from backpacks_flash_attn_tpu.ops import cross_entropy as jce
from backpacks_flash_attn_tpu.training import train as jtrain
from backpacks_flash_attn_tpu_torch import config as tcfg
from backpacks_flash_attn_tpu_torch.data import lm_dataset as lmd
from backpacks_flash_attn_tpu_torch.ops import flash_attention as tfa
from backpacks_flash_attn_tpu_torch.parallel import launch
from backpacks_flash_attn_tpu_torch.training import train as ttrain
from backpacks_flash_attn_tpu_torch.training import train_cli as tcli
from backpacks_flash_attn_tpu_torch.utils import prng
from backpacks_flash_attn_tpu_torch.utils.weights import params_from_numpy

torch.set_num_threads(1)

RANKS = str(Path(__file__).with_name("torch_parallel_ranks.py")) + ":run_cases"
LOSS_RTOL, GRAD_NORM_RTOL = 1e-5, 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
MU_ATOL = 1e-8      # the first moments: 1e-5 of their largest entries (~1e-3)
DATA, MODEL = 2, 2
# tests/parallel/test_parallel.py:29: heads, senses, inner and vocabulary
# divide over 'model'; dropout at its default 0.1
BP = dict(vocab_size=512, n_positions=64, n_embd=64, n_layer=2, n_head=4,
          num_senses=4, scale_attn_by_inverse_layer_idx=True,
          pad_vocab_size_multiple=8)
GPT = dict(vocab_size=512, n_positions=128, n_embd=64, n_head=4, n_layer=2)  # gpt2-test
OPT = dict(warmup_steps=2, total_steps=10)
STEPS, RNG = 3, 3

# name: (model, fused_ctx, zero, remat)
CASES = {
    "backpack-einsum": ("backpack", False, 0, "none"),
    "backpack-fused": ("backpack", True, 0, "none"),
    "gpt2-test": ("gpt", None, 0, "none"),
    "zero1": ("backpack", False, 1, "none"),
    "zero2": ("backpack", False, 2, "none"),
    "zero3": ("backpack", False, 3, "none"),
    "zero3-remat-dots": ("backpack", True, 3, "dots"),
}
CE_CASES = {"ce": 0.0, "ce-smoothing": 0.1}


def _jparams(model):
    if model == "gpt":
        return jgpt.init_gpt_lm(GPTConfig(**GPT), jax.random.PRNGKey(0))
    return jbp.init_backpack(BackpackConfig(**BP), jax.random.PRNGKey(0))


def _ids():
    return np.random.default_rng(0).integers(0, 512, (4, 17)).astype(np.int32)


def _ce_inputs(smoothing):
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(2, 6, 64)).astype(np.float32)
    labels = rng.integers(0, 64, (2, 6))
    labels[0, 0] = -100                 # the ignore index
    w = rng.normal(size=(2, 6)).astype(np.float32)
    return logits, labels, w


@pytest.fixture(scope="module")
def port():
    """Every case on one world of 4 ranks; rank 0's result, each step's
    loss and gradient norm equal on every rank."""
    cases = []
    for name, (model, fused, zero, remat) in CASES.items():
        cases.append(dict(kind="shard", cfg=GPT if model == "gpt" else BP, model=model,
                          data=DATA, model_size=MODEL, zero=zero, fused_ctx=fused,
                          remat=remat, opt=OPT, ids=_ids(), rng=RNG, steps=STEPS,
                          params=jax.tree.map(np.asarray, _jparams(model))))
    for smoothing in CE_CASES.values():
        logits, labels, w = _ce_inputs(smoothing)
        cases.append(dict(kind="vocab_ce", data=DATA, model_size=MODEL, logits=logits,
                          labels=labels, w=w, smoothing=smoothing))
    cases.append(dict(kind="collectives", data=DATA, model_size=MODEL))
    ranks = launch.run_world(RANKS, DATA * MODEL, args=(cases,), threads=1, timeout=600)
    out = {}
    for i, name in enumerate(list(CASES) + list(CE_CASES) + ["collectives"]):
        out[name] = [r[i] for r in ranks]
    for name in CASES:
        for r in out[name]:
            assert r["loss"] == out[name][0]["loss"], name
            assert r["grad_norm"] == out[name][0]["grad_norm"], name
    return out


def _jax_run(model, fused):
    """JAX's unsharded step, STEPS times: the losses, gradient norms, and
    the parameters and AdamW's first moments after the last step."""
    params = _jparams(model)
    cfg = GPTConfig(**GPT) if model == "gpt" else BackpackConfig(**BP)
    tx = jtrain.make_optimizer(params, **OPT)
    state = jtrain.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    kw = {} if model == "gpt" else {"fused_ctx": fused}
    step = jax.jit(jtrain.make_train_step(cfg, tx, model=model, **kw))
    batch = {"input_ids": jnp.asarray(_ids())}
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = step(state, batch, jax.random.PRNGKey(RNG))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    mu = state.opt_state[1][0].mu
    return losses, norms, jax.tree.map(np.asarray, state.params), jax.tree.map(np.asarray, mu)


_JAX = {}


def _jax(model, fused):
    if (model, fused) not in _JAX:
        _JAX[(model, fused)] = _jax_run(model, fused)
    return _JAX[(model, fused)]


def _leaves(tree):
    return dict(ttrain.named_leaves(tree))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax(port, name):
    """The DP x TP step (Backpack on both combine routes, gpt2-test, ZeRO-1,
    -2 and -3, ZeRO-3 under remat "dots") against JAX's unsharded step:
    three steps' losses and gradient norms, the parameters and first
    moments after them (the checkpoint's gathered tree)."""
    model, fused, zero, _ = CASES[name]
    losses, norms, params, mu = _jax(model, fused)
    got = port[name][0]
    np.testing.assert_allclose(got["loss"], losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], norms, rtol=GRAD_NORM_RTOL)
    for want, have, atol in ((params, got["params"], PARAM_ATOL),
                             (mu, got["mu"], MU_ATOL)):
        want, have = _leaves(want), _leaves(have)
        assert want.keys() == have.keys()
        for k, v in want.items():
            np.testing.assert_allclose(have[k], v, rtol=PARAM_RTOL, atol=atol,
                                       err_msg=f"{name} {'/'.join(k)}")


@pytest.mark.parametrize("name,params_share,moments_share", [
    ("backpack-einsum", 1 / MODEL, 2 / MODEL),
    ("zero1", 1 / MODEL, 2 / (MODEL * DATA)),
    ("zero2", 1 / MODEL, 2 / (MODEL * DATA)),
    ("zero3", 1 / (MODEL * DATA), 2 / (MODEL * DATA)),
])
def test_sharded_memory(port, name, params_share, moments_share):
    """What a rank holds against the whole tree: its Megatron slices
    (norms, row-parallel biases and the other replicated leaves keep it a
    little above 1 / model), ZeRO-1/2 also its 'data' slice of the AdamW
    moments, ZeRO-3 of the parameters too."""
    got = port[name][0]
    whole = got["bytes"]
    assert params_share <= got["local_bytes"]["params"] / whole < params_share * 1.1
    assert moments_share <= got["local_bytes"]["moments"] / whole < moments_share * 1.1


@pytest.mark.parametrize("name", list(CE_CASES))
def test_vocab_parallel_cross_entropy_matches_jax(port, name):
    """The port's vocab-parallel loss over the 'model' group against JAX's
    under shard_map (model 2, the ignore index at [0, 0]), and its gradient
    in each rank's columns against JAX's dense cross_entropy's."""
    from jax import shard_map
    smoothing = CE_CASES[name]
    logits, labels, w = _ce_inputs(smoothing)
    mesh = Mesh(np.asarray(jax.devices()[:MODEL]).reshape(1, MODEL), ("data", "model"))
    f = shard_map(lambda lg, lb: jce.vocab_parallel_cross_entropy(
        lg, lb, "model", label_smoothing=smoothing), mesh=mesh,
        in_specs=(P(None, None, "model"), P(None, None)), out_specs=P(None, None))
    want = np.asarray(f(jnp.asarray(logits), jnp.asarray(labels)))
    grad = np.asarray(jax.grad(lambda lg: jnp.sum(jce.cross_entropy(
        lg, jnp.asarray(labels), label_smoothing=smoothing)[0] * w))(jnp.asarray(logits)))
    v = logits.shape[-1] // MODEL
    for r, got in enumerate(port[name]):
        np.testing.assert_allclose(got["loss"], want, rtol=1e-5, atol=1e-6)
        cols = (r % MODEL) * v
        np.testing.assert_allclose(got["grad"], grad[..., cols:cols + v], rtol=1e-5,
                                   atol=1e-7)


def test_training_collectives(port):
    """parallel/mesh.py's collectives on the (data 2, model 2) world (rank
    r at (r // 2, r % 2); rank r's x = r + arange(6) as (2, 3), its
    upstream gradient r + 1): copy_to is the identity forward and sums the
    gradient over 'model'; reduce_from sums over 'model' forward and passes
    the gradient; gather_from concatenates over 'model' (dim 1) and hands
    back each rank's slice of the gradient; gather_scatter concatenates
    over 'data' (dim 0) and sums each rank's slice of the gradient over
    'data'; reduce_scatter, all_gather_slices and group_max as named."""
    base = np.arange(6.0).reshape(2, 3)
    for r, got in enumerate(port["collectives"]):
        pair = [r - r % MODEL + j for j in range(MODEL)]          # r's 'model' group
        col = [r % MODEL + MODEL * i for i in range(DATA)]        # r's 'data' group
        x = r + base
        y, g = got["copy_to"]
        np.testing.assert_array_equal(y, x)
        np.testing.assert_array_equal(g, np.full_like(x, sum(q + 1 for q in pair)))
        y, g = got["reduce_from"]
        np.testing.assert_array_equal(y, sum(q + base for q in pair))
        np.testing.assert_array_equal(g, np.full_like(x, r + 1))
        y, g = got["gather_from"]
        np.testing.assert_array_equal(y, np.concatenate([q + base for q in pair], 1))
        np.testing.assert_array_equal(g, np.full_like(x, r + 1))
        y, g = got["gather_scatter"]
        np.testing.assert_array_equal(y, np.concatenate([q + base for q in col], 0))
        np.testing.assert_array_equal(g, np.full_like(x, sum(q + 1 for q in col)))
        t = lambda q: q + np.arange(8.0).reshape(4, 2)
        i = col.index(r)
        np.testing.assert_array_equal(got["reduce_scatter"],
                                      sum(t(q) for q in col)[2 * i:2 * i + 2])
        np.testing.assert_array_equal(got["all_gather_slices"],
                                      np.concatenate([t(q) for q in col], 1))
        np.testing.assert_array_equal(got["group_max"], t(max(pair)))


@pytest.mark.parametrize("b,h,h0,hg,boff", [(2, 2, 2, 4, 0), (3, 1, 5, 6, 7), (1, 4, 0, 4, 2)])
def test_keep_mask_head_shard_is_the_slice(b, h, h0, hg, boff):
    """A head shard's dropout mask (heads [h0, h0 + h) of hg, rows from
    boff) is the slice of the unsharded call's, bit for bit."""
    full = tfa._keep_mask((7, 9), 0.1, boff + b, hg, 33, 40, None, "cpu")
    part = tfa._keep_mask((7, 9), 0.1, b, h, 33, 40, None, "cpu", bh_offset=boff,
                          head_offset=h0, global_heads=hg)
    assert torch.equal(part, full[boff:, h0:h0 + h])


_TEST_PARAMS = {}


def _test_params():
    """backpack-test's JAX weights as numpy (drawn once)."""
    if not _TEST_PARAMS:
        _TEST_PARAMS["p"] = jax.tree.map(
            np.asarray, jbp.init_backpack(backpack_test(), jax.random.PRNGKey(0)))
    return _TEST_PARAMS["p"]


def _port_params():
    return ttrain.trainable(params_from_numpy(_test_params(), device="cpu"))


@pytest.mark.parametrize("fused_ctx", [False, True])
def test_remat_modes_match(fused_ctx):
    """remat "full" (a checkpoint a block, and the einsum route's whole
    combine) and "dots" (matrix products saved, the rest recomputed)
    against "none", dropout on: JAX's tolerances (tests/training/
    test_harness.py:174), loss rtol 1e-6 and gradient norm rtol 1e-5; every
    leaf's gradient too (the recomputation redraws the same masks)."""
    cfg = tcfg.backpack_test()
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 17)))
    want = None
    for remat in ("none", "full", "dots"):
        params = _port_params()
        loss = ttrain.make_loss_fn(cfg, remat=remat, fused_ctx=fused_ctx)(
            params, {"input_ids": ids}, prng.PRNGKey(2))
        loss.backward()
        grads = [t.grad for _, t in ttrain.named_leaves(params)]
        gnorm = ttrain.local_norm(grads).item()
        if want is None:
            want = (loss.item(), gnorm, grads)
            continue
        np.testing.assert_allclose(loss.item(), want[0], rtol=1e-6)
        np.testing.assert_allclose(gnorm, want[1], rtol=1e-5)
        for g, w in zip(grads, want[2]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-9)


def test_accumulation_matches_multisteps():
    """make_optimizer(accum_steps=2) against optax.MultiSteps over four
    calls of two alternating batches (two updates): each call's loss and
    gradient norm, and the parameters after every call (unchanged after
    the first of each pair)."""
    cfg_j = backpack_test()
    jparams = jax.tree.map(jnp.asarray, _test_params())
    tx = jtrain.make_optimizer(jparams, accum_steps=2, lr=1e-3, **OPT)
    jstate = jtrain.TrainState(jparams, tx.init(jparams), jnp.zeros((), jnp.int32))
    jstep = jax.jit(jtrain.make_train_step(cfg_j, tx))
    params = _port_params()
    tstate = ttrain.TrainState(params, ttrain.make_optimizer(params, accum_steps=2, lr=1e-3,
                                                             **OPT), 0)
    tstep = ttrain.make_train_step(tcfg.backpack_test())
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, 512, (2, 17)).astype(np.int32) for _ in range(2)]
    before = None
    for call in range(4):
        ids = batches[call % 2]
        jstate, jm = jstep(jstate, {"input_ids": jnp.asarray(ids)}, jax.random.PRNGKey(1))
        tstate, tm = tstep(tstate, {"input_ids": torch.from_numpy(ids).long()},
                           prng.PRNGKey(1))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4, err_msg=k)
        want = _leaves(jax.tree.map(np.asarray, jstate.params))
        got = _leaves(ttrain._map_leaves(lambda _, t: t.detach().numpy().copy(),
                                         tstate.params))
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg="/".join(k))
        if call % 2 == 1:
            assert tstate.opt_state.updated and tstate.opt_state.mini_step == 0
        else:
            assert not tstate.opt_state.updated
            if before is not None:
                for k, v in got.items():
                    np.testing.assert_array_equal(v, before[k])
        before = got
    assert tstate.step == 4 and tstate.opt_state.update_count() == 2


def _cli_losses(work):
    rows = [json.loads(line) for line in open(work / "metrics.jsonl")]
    return ([r["loss"] for r in rows if "loss" in r],
            [r["grad_norm"] for r in rows if "grad_norm" in r])


def test_train_cli_sharded_matches_single_device(tmp_path):
    """The CLI at --tp 2 and at --zero3 --dp 2 (each a world of 2 gloo
    ranks it starts itself) logs the losses and gradient norms of its
    --tp 1 run, step by step; each saves the whole tree at step 2, which a
    --tp 1 run in the same directory resumes (the sampler's position too),
    and its steps 2 and 3 are the straight run's."""
    tokens = np.random.default_rng(2).integers(0, 500, 6000).astype(np.uint16)
    corpus = lmd.save_corpus(tokens, str(tmp_path), "c")
    kw = dict(corpus=corpus, model="backpack-test", batch_size=4, seqlen=32,
              warmup_steps=2, log_every=1, device="cpu", ckpt_every=0)
    tcli.run(tcli.RunConfig(workdir=str(tmp_path / "single"), steps=4, **kw))
    want = _cli_losses(tmp_path / "single")
    assert len(want[0]) == 4
    for name, extra in (("tp2", dict(tp=2)), ("zero3", dict(zero3=True, dp=2))):
        work = tmp_path / name
        tcli.run(tcli.RunConfig(workdir=str(work), steps=2, **kw, **extra))
        assert sorted(p.name for p in work.glob("*.ckpt.npz")) == ["step_00000002.ckpt.npz"]
        tcli.run(tcli.RunConfig(workdir=str(work), steps=4, **kw))
        losses, norms = _cli_losses(work)
        np.testing.assert_allclose(losses, want[0], rtol=2e-6, err_msg=name)
        np.testing.assert_allclose(norms, want[1], rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("extra,match", [(dict(remat="some"), "--remat"),
                                         (dict(tp=2, ema_decay=0.99), "--ema-decay"),
                                         (dict(cp=2, remat="full"), "--remat")])
def test_train_cli_refusals(extra, match):
    """What the sharded CLI refuses before it starts a world: an unknown
    --remat, EMA on a sharded run (its shadow would be a rank's shards),
    --remat under --cp."""
    with pytest.raises(ValueError, match=match):
        tcli.run(tcli.RunConfig(corpus="", device="cpu", **extra))
