"""The ranks' side of the port's parallel tests (tests/test_torch_ring_attention.py,
tests/test_torch_cp_train.py): functions that ``parallel/launch.run_world``
runs on every rank of a gloo world on the CPU. JAX-free (a child that
imports JAX can hang on the TPU plugin): inputs and outputs are numpy.
"""

import numpy as np
import torch

from backpacks_flash_attn_tpu_torch import config as tcfg
from backpacks_flash_attn_tpu_torch.parallel import cp_train as cp
from backpacks_flash_attn_tpu_torch.parallel import mesh as mesh_lib
from backpacks_flash_attn_tpu_torch.parallel import ring_attention as ra
from backpacks_flash_attn_tpu_torch.training import train as tl
from backpacks_flash_attn_tpu_torch.utils import prng
from backpacks_flash_attn_tpu_torch.utils.weights import params_from_numpy

_MESHES = {}


def _mesh(data, seq):
    if (data, seq) not in _MESHES:
        _MESHES[(data, seq)] = mesh_lib.make_cp_mesh(data, seq)
    return _MESHES[(data, seq)]


def _leaf(a):
    return torch.from_numpy(np.asarray(a, np.float32)).requires_grad_()


def ring_case(case):
    """One attention case on this rank. ``entry`` "global": make_ring_attention
    or make_zigzag_ring_attention on the whole (b, s, h, d) tensors, -> the
    global output and gradients of sum(out * t); "local": this rank's
    chunk (zigzag-ordered for the zigzag forms) through a *_local function,
    -> its output rows and its chunk's gradients."""
    mesh = _mesh(case.get("data", 1), case["seq"])
    ring = mesh_lib.ring_of(mesh, "seq")
    q, k, v, t = (np.asarray(case[n], np.float32) for n in "qkvt")
    fn, kw = case["fn"], dict(case.get("kw", {}))
    if case["entry"] == "global":
        make = (ra.make_zigzag_ring_attention if fn == "zigzag"
                else ra.make_ring_attention)
        attn = make(mesh, **kw)
        tq, tk, tv = _leaf(q), _leaf(k), _leaf(v)
        out = attn(tq, tk, tv)
        (out * torch.from_numpy(t)).sum().backward()
        return {"out": out.detach().numpy(),
                "grads": [x.grad.numpy() for x in (tq, tk, tv)]}
    if "dropout_key" in case:
        kw["dropout_rng"] = prng.PRNGKey(case["dropout_key"])
    s, n = q.shape[1], ring.size
    if fn.startswith("zigzag"):
        order = ra.zigzag_order(s, n).numpy()
        q, k, v, t = (x[:, order] for x in (q, k, v, t))
    c = s // n
    part = lambda x: x[:, ring.rank * c:(ring.rank + 1) * c]
    tq, tk, tv = _leaf(part(q)), _leaf(part(k)), _leaf(part(v))
    local = {"flash": ra.ring_flash_attention_local,
             "einsum": ra.ring_attention_local,
             "zigzag": ra.zigzag_ring_attention_local,
             "zigzag_einsum": ra.zigzag_ring_attention_local_einsum}[fn]
    out = local(tq, tk, tv, ring=ring, **kw)
    (out * torch.from_numpy(np.ascontiguousarray(part(t)))).sum().backward()
    return {"out": out.detach().numpy(),
            "grads": [x.grad.numpy() for x in (tq, tk, tv)]}


def _config(case):
    """The case's config (a BackpackConfig, whose GPT fields serve
    model="gpt" too, as in JAX's tests) and model kind."""
    return tcfg.BackpackConfig(**case["cfg"]), case["model"]


def _grads(params):
    return {"/".join(path): t.grad.numpy().copy()
            for path, t in tl.named_leaves(params)}


def cp_case(case):
    """One context-parallel case on this rank: the loss of make_cp_loss_fn,
    the mean of this rank's per-token losses (return_per_token) and, after
    backward and reduce_grads, every gradient (keyed by path);
    with ``steps``, the losses of that many make_cp_train_step steps
    instead. ``error``: the message make_cp_loss_fn raises, if it does."""
    cfg, kind = _config(case)
    mesh = _mesh(case["data"], case["seq"])
    params = tl.trainable(params_from_numpy(case["params"], device="cpu"))
    if case.get("moe_layer"):
        # a layer tree carrying an MoE block (the port has no MoE init yet)
        params["layers"]["moe"] = torch.zeros(cfg.n_layer, 1)
    ids = torch.from_numpy(np.asarray(case["ids"])).long()
    train = case.get("train", False)
    rng = prng.PRNGKey(case["rng"]) if train else None
    kw = dict(attn_impl=case.get("impl", "einsum"), layout=case.get("layout", "natural"),
              train=train, model=kind)
    if "steps" in case:
        opt = tl.make_optimizer(params, lr=1e-2, warmup_steps=1, total_steps=10)
        step = cp.make_cp_train_step(cfg, opt, mesh, **kw)
        losses = []
        for _ in range(case["steps"]):
            params, opt, loss = step(params, opt, ids, rng)
            losses.append(loss.item())
        return {"losses": losses}
    try:
        loss, per_token = cp.make_cp_loss_fn(cfg, mesh, return_per_token=True,
                                             **kw)(params, ids, rng)
    except (ValueError, NotImplementedError) as err:
        return {"error": str(err)}
    loss.backward()
    cp.reduce_grads(params)
    return {"loss": loss.item(), "per_token_mean": per_token.mean().item(),
            "grads": _grads(params)}


def run_cases(cases):
    """Every case of ``cases`` (each {"kind": "ring" | "cp", ...}) in order
    on this rank; -> their results."""
    fns = {"ring": ring_case, "cp": cp_case}
    return [fns[c["kind"]](c) for c in cases]
