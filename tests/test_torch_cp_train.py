"""The port's context-parallel training (parallel/cp_train.py, the
training CLI's --cp) against the JAX package's, on the CPU.

JAX's ``make_cp_loss_fn`` on virtual CPU devices (tests/conftest.py forces
8) against the port's over gloo worlds of 2 and 4 processes
(``parallel/launch.py``; the ranks' side in tests/torch_parallel_ranks.py,
which imports no JAX), with the same weights (``params_from_numpy``) and
ids: the Backpack and GPT models, the natural and zigzag layouts, the
flash and einsum rings, (data, seq) meshes of (2, 2), (1, 4) and (1, 2),
rotary at per-chunk offsets, and every dropout site at global positions.
Tolerances are JAX's own in f32 (tests/parallel/test_cp_train.py): the
loss to rel 2e-5, each gradient to atol 2e-5, rtol 2e-4. Three AdamW
steps of ``make_cp_train_step`` against JAX's to rel 1e-4 (the updates
carry the gradients' rounding into the weights); the CLI's --cp 2
against its single-device run to rel 2e-5 a step (its gradient norms to
rel 1e-5: their readings are ~1e-7).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from backpacks_flash_attn_tpu.config import BackpackConfig
from backpacks_flash_attn_tpu.models import backpack as jbp
from backpacks_flash_attn_tpu.parallel import cp_train as jcp
from backpacks_flash_attn_tpu.training import train as jtrain
from backpacks_flash_attn_tpu_torch.data import lm_dataset as lmd
from backpacks_flash_attn_tpu_torch.parallel import launch
from backpacks_flash_attn_tpu_torch.training import train_cli as tcli

torch.set_num_threads(1)

RANKS = str(Path(__file__).with_name("torch_parallel_ranks.py")) + ":run_cases"
LOSS_REL = 2e-5
ATOL, RTOL = 2e-5, 2e-4
STEP_REL = 1e-4
GRAD_NORM_REL = 1e-5

BASE = dict(vocab_size=512, n_positions=128, n_embd=64, n_head=4, n_layer=2,
            num_senses=4, scale_attn_by_inverse_layer_idx=True,
            pad_vocab_size_multiple=8, embd_pdrop=0.0, resid_pdrop=0.0,
            attn_pdrop=0.0)
ROTARY = dict(vocab_size=256, n_positions=0, n_embd=64, n_head=4, n_layer=2,
              num_senses=2, rotary_emb_fraction=0.5, pad_vocab_size_multiple=8,
              embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
DROPOUT = dict(vocab_size=256, n_positions=64, n_embd=32, n_head=2, n_layer=2,
               num_senses=2, pad_vocab_size_multiple=8, embd_pdrop=0.15,
               resid_pdrop=0.1, attn_pdrop=0.35)

# name: (world, config, model, ids (batch, seq + 1), data, seq, layout,
#        attn impl, train)
CASES = {
    "einsum-natural-d2s2": (4, BASE, "backpack", (2, 65), 2, 2, "natural", "einsum", False),
    "flash-natural-d1s4": (4, BASE, "backpack", (2, 65), 1, 4, "natural", "flash", False),
    "flash-zigzag-d1s2": (2, BASE, "backpack", (2, 65), 1, 2, "zigzag", "flash", False),
    "einsum-zigzag-d2s2": (4, BASE, "backpack", (2, 65), 2, 2, "zigzag", "einsum", False),
    "rotary-flash-zigzag-d1s2": (2, ROTARY, "backpack", (2, 33), 1, 2, "zigzag", "flash", False),
    "rotary-einsum-natural-d1s4": (4, ROTARY, "backpack", (2, 33), 1, 4, "natural", "einsum", False),
    "dropout-flash-natural-d2s2": (4, DROPOUT, "backpack", (4, 33), 2, 2, "natural", "flash", True),
    "dropout-einsum-zigzag-d1s2": (2, DROPOUT, "backpack", (2, 33), 1, 2, "zigzag", "einsum", True),
    "gpt-flash-natural-d1s4": (4, BASE, "gpt", (2, 33), 1, 4, "natural", "flash", False),
    "gpt-dropout-flash-zigzag-d2s2": (4, DROPOUT, "gpt", (4, 33), 2, 2, "zigzag", "flash", True),
}
RNG = 9


def _jparams(model, cfg):
    params = jbp.init_backpack(cfg, jax.random.PRNGKey(0))
    return params["gpt"] if model == "gpt" else params


def _ids(shape, vocab):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(1), shape, 0, vocab),
                      np.int32)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


def _mesh(data, seq):
    return Mesh(np.asarray(jax.devices()[:data * seq]).reshape(data, seq),
                ("data", "seq"))


def _port_case(name):
    world, cfgkw, model, shape, data, seq, layout, impl, train = CASES[name]
    cfg = BackpackConfig(**cfgkw)
    return dict(kind="cp", cfg=cfgkw, model=model, data=data, seq=seq,
                layout=layout, impl=impl, train=train, rng=RNG,
                ids=_ids(shape, cfg.vocab_size),
                params=jax.tree.map(np.asarray, _jparams(model, cfg)))


# the extra cases of the world of 2: three train steps, the int32 guard of
# the per-token dropout positions, and an MoE layer
def _extra_cases():
    steps = dict(_port_case("flash-natural-d1s4"), seq=2, steps=3)
    huge = dict(_port_case("dropout-einsum-zigzag-d1s2"),
                cfg=dict(DROPOUT, n_embd=2 ** 26))
    moe = dict(_port_case("gpt-flash-natural-d1s4"), seq=2, moe_layer=True)
    return {"steps": steps, "guard": huge, "moe": moe}


@pytest.fixture(scope="module")
def port():
    """Every case on its world, rank 0's result; every rank's loss agrees,
    and is the mean of the ranks' per-token losses (return_per_token; the
    ranks hold equal counts)."""
    out = {}
    extra = _extra_cases()
    for world in (2, 4):
        names = [n for n, c in CASES.items() if c[0] == world]
        cases = [_port_case(n) for n in names]
        if world == 2:
            names += list(extra)
            cases += list(extra.values())
        ranks = launch.run_world(RANKS, world, args=(cases,), threads=1,
                                 timeout=600)
        for i, n in enumerate(names):
            out[n] = ranks[0][i]
            if "loss" in out[n]:
                assert all(r[i]["loss"] == out[n]["loss"] for r in ranks)
                per_token = np.mean([r[i]["per_token_mean"] for r in ranks])
                assert per_token == pytest.approx(out[n]["loss"], rel=1e-6), n
    return out


def _jax_loss_and_grads(name):
    world, cfgkw, model, shape, data, seq, layout, impl, train = CASES[name]
    cfg = BackpackConfig(**cfgkw)
    params = _jparams(model, cfg)
    ids = jnp.asarray(_ids(shape, cfg.vocab_size))
    mesh = _mesh(data, seq)
    loss_fn = jcp.make_cp_loss_fn(cfg, mesh, attn_impl=impl, train=train,
                                  layout=layout, model=model)
    args = (ids, jax.random.PRNGKey(RNG)) if train else (ids,)
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, *args)
    return float(loss), _flat(jax.device_get(grads))


@pytest.mark.parametrize("name", list(CASES))
def test_cp_loss_and_grads_match_jax(port, name):
    loss, grads = _jax_loss_and_grads(name)
    got = port[name]
    assert got["loss"] == pytest.approx(loss, rel=LOSS_REL), (got["loss"], loss)
    assert got["grads"].keys() == grads.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(got["grads"][k], g, atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def test_cp_train_steps_match_jax(port):
    c = _extra_cases()["steps"]
    cfg = BackpackConfig(**c["cfg"])
    params = jax.tree.map(jnp.asarray, c["params"])
    tx = jtrain.make_optimizer(params, lr=1e-2, warmup_steps=1, total_steps=10)
    mesh = _mesh(1, 2)
    step = jcp.make_cp_train_step(cfg, tx, mesh, attn_impl="flash")
    opt_state = jax.jit(tx.init)(params)
    ids = jnp.asarray(c["ids"])
    want = []
    with mesh:
        for _ in range(3):
            params, opt_state, loss = step(params, opt_state, ids)
            want.append(float(loss))
    got = port["steps"]["losses"]
    np.testing.assert_allclose(got, want, rtol=STEP_REL)
    assert got[-1] < got[0], got


def test_cp_refusals(port):
    """The int32 guard of the per-token dropout positions (JAX :142-152)
    and an MoE layer (ROADMAP Queue 1 item 7) raise on every rank before
    any ring step."""
    assert "2**31" in port["guard"]["error"]
    assert "item 7" in port["moe"]["error"]
    with pytest.raises(ValueError, match="attn_dwconv"):
        from backpacks_flash_attn_tpu_torch import config as tcfg
        from backpacks_flash_attn_tpu_torch.parallel import cp_train as tcp
        tcp._make_local_loss(tcfg.BackpackConfig(**dict(BASE, attn_dwconv=True)))


def test_train_cli_cp_matches_single_device(tmp_path):
    """The CLI's --cp 2 (a world of 2 gloo ranks it starts itself) logs the
    losses and gradient norms of its single-device run, step by step, in
    both layouts; --dp 2 --cp 2 too; rank 0 alone writes the metrics and
    checkpoints."""
    tokens = np.random.default_rng(2).integers(0, 500, 6000).astype(np.uint16)
    corpus = lmd.save_corpus(tokens, str(tmp_path), "c")
    kw = dict(corpus=corpus, model="backpack-test", batch_size=4, seqlen=32,
              warmup_steps=2, log_every=1, device="cpu", steps=3,
              ckpt_every=2)
    losses, norms = {}, {}
    for name, extra in (("single", {}), ("cp2", dict(cp=2)),
                        ("zigzag", dict(cp=2, cp_layout="zigzag",
                                        cp_attn_impl="einsum")),
                        ("dp2cp2", dict(cp=2, dp=2))):
        work = tmp_path / name
        out = tcli.run(tcli.RunConfig(workdir=str(work), **kw, **extra))
        assert out["steps"] == 3
        rows = [json.loads(line) for line in open(work / "metrics.jsonl")]
        losses[name] = [r["loss"] for r in rows if "loss" in r]
        norms[name] = [r["grad_norm"] for r in rows if "grad_norm" in r]
        assert sorted(p.name for p in work.glob("*.ckpt.npz")) == [
            "step_00000002.ckpt.npz", "step_00000003.ckpt.npz"]
    assert len(losses["single"]) == 3
    for name in ("cp2", "zigzag", "dp2cp2"):
        np.testing.assert_allclose(losses[name], losses["single"], rtol=LOSS_REL,
                                   err_msg=name)
        np.testing.assert_allclose(norms[name], norms["single"], rtol=GRAD_NORM_REL,
                                   err_msg=name)
