"""The ranks' side of the port's parallel tests (tests/test_torch_ring_attention.py,
tests/test_torch_cp_train.py, tests/test_torch_tp_decode.py,
tests/test_torch_sharded_train.py): functions that
``parallel/launch.run_world`` runs on every rank of a gloo world on the CPU. JAX-free (a child that
imports JAX can hang on the TPU plugin): inputs and outputs are numpy.
"""

import dataclasses

import numpy as np
import torch

from backpacks_flash_attn_tpu_torch import config as tcfg
from backpacks_flash_attn_tpu_torch.models import backpack as tbp
from backpacks_flash_attn_tpu_torch.models import gpt as tgpt
from backpacks_flash_attn_tpu_torch.models import quantized as tqz
from backpacks_flash_attn_tpu_torch.parallel import cp_train as cp
from backpacks_flash_attn_tpu_torch.parallel import mesh as mesh_lib
from backpacks_flash_attn_tpu_torch.parallel import ring_attention as ra
from backpacks_flash_attn_tpu_torch.parallel import serving
from backpacks_flash_attn_tpu_torch.parallel import tp_decode as tpd
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


_TP_MESHES = {}


def _tp_mesh(data, model):
    if (data, model) not in _TP_MESHES:
        _TP_MESHES[(data, model)] = mesh_lib.make_mesh(data, model)
    return _TP_MESHES[(data, model)]


def cache_from_numpy(c):
    """A flat BackpackCache from the numpy arrays of ``cache_to_numpy`` (a
    scalar length as an int)."""
    t = lambda x: None if x is None else torch.from_numpy(np.array(x))
    n = lambda x: int(x) if np.ndim(x) == 0 else torch.from_numpy(np.array(x, np.int32))
    gpt = tgpt.KVCache(k=t(c["k"]), v=t(c["v"]), length=n(c["gpt_length"]),
                       k_scale=t(c["k_scale"]), v_scale=t(c["v_scale"]))
    return tbp.BackpackCache(gpt=gpt, ctx_k=t(c["ctx_k"]), content=t(c["content"]),
                             length=n(c["length"]), content_scale=t(c["content_scale"]),
                             ctx_k_scale=t(c["ctx_k_scale"]))


def cache_to_numpy(cache):
    a = lambda x: None if x is None else x.numpy()
    n = lambda x: np.asarray(x if isinstance(x, int) else x.numpy())
    g = cache.gpt
    return dict(k=a(g.k), v=a(g.v), k_scale=a(g.k_scale), v_scale=a(g.v_scale),
                gpt_length=n(g.length), ctx_k=a(cache.ctx_k), content=a(cache.content),
                ctx_k_scale=a(cache.ctx_k_scale), content_scale=a(cache.content_scale),
                length=n(cache.length))


def _nbytes(tree):
    out = 0

    def count(t, _):
        nonlocal out
        out += t.numel() * t.element_size()
        return t
    mesh_lib.map_with_specs(count, tree, mesh_lib.replicated(tree))
    return out


def _refusals(cfg, mesh, params, cache):
    """The messages of what tp_decode refuses (JAX's asserts): heads or
    senses, or the padded vocabulary, not dividing over 'model', attn_dwconv,
    three microbatches, an INT4 tree, grouped INT8 scales."""
    base = dict(vocab_size=cfg.vocab_size, n_positions=cfg.n_positions, n_embd=64,
                n_layer=2, n_head=4, num_senses=4, pad_vocab_size_multiple=8)
    model = mesh.size(1)
    tries = {
        "heads": lambda: tpd.make_tp_decode_step(
            tcfg.BackpackConfig(**dict(base, n_head=model // 2, num_senses=model)), mesh),
        "vocab": lambda: tpd.make_tp_decode_step(
            tcfg.BackpackConfig(**dict(base, vocab_size=513, pad_vocab_size_multiple=1)),
            mesh),
        "dwconv": lambda: tpd.make_tp_decode_step(
            tcfg.BackpackConfig(**dict(base, attn_dwconv=True)), mesh),
        "microbatches": lambda: tpd.make_tp_decode_step(cfg, mesh, microbatches=3),
        "int4": lambda: tpd.make_tp_decode_step(cfg, mesh)[1](
            tqz.quantize_backpack_params(params, cfg, bits=4), cache),
        "grouped": lambda: tpd.make_tp_decode_step(cfg, mesh)[1](
            tqz.quantize_backpack_params(params, cfg, bits=8, group_size=32), cache),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            out[name] = None
        except ValueError as err:
            out[name] = str(err)
    return out


def tp_case(case):
    """One tensor-parallel serving case on this rank, at mesh (data,
    model): ``entry`` "step" (make_tp_decode_step, teacher-forced on
    ``tokens``), "scan" (make_tp_decode_scan from ``tokens[0]``),
    "serving" (make_sharded_decode_step, ``tp_params``), "int4"
    (make_sharded_decode_step with tp_params over the INT4 tree of
    ``params``, and the single-device step on this rank beside it) or
    "refusals". -> the global logits of
    every step (gathered over 'data'), the global cache at the end as a flat
    numpy cache, and what the entry adds."""
    cfg = tcfg.BackpackConfig(**case["cfg"])
    mesh = _tp_mesh(case["data"], case["model"])
    params = params_from_numpy(case["params"], device="cpu")
    cache = cache_from_numpy(case["cache"])
    tokens = [torch.from_numpy(np.asarray(t)).long() for t in case["tokens"]]
    entry = case["entry"]
    if entry == "refusals":
        return _refusals(cfg, mesh, params, cache)
    if entry == "int4":
        step, prepare = serving.make_sharded_decode_step(cfg, mesh, tp_params=True)
        p, c = prepare(params, cache)
        single = cache_from_numpy(case["cache"])
        logits, diffs = [], []
        for tok in tokens:
            got, c = step(p, mesh_lib.data_rows(tok, mesh), c)
            got = mesh_lib.gather_rows(got, mesh)
            want, single = tbp.backpack_forward_with_cache(params, cfg, tok, single)
            logits.append(got.numpy())
            diffs.append((got - want).abs().max().item())
        whole = mesh_lib.gather_tree(c, serving.cache_specs(c), mesh)
        return {"logits": logits, "cache": cache_to_numpy(whole), "diffs": diffs,
                "local_bytes": _nbytes(p), "bytes": _nbytes(params)}
    out = {}
    if entry in ("step", "scan"):
        kw = dict(window=case.get("window"), microbatches=case.get("microbatches", 2))
        step, prepare = tpd.make_tp_decode_step(cfg, mesh, **kw)
        p, c = prepare(params, cache)
        if entry == "scan":
            start = mesh_lib.data_rows(tokens[0], mesh)
            kept = tpd.make_tp_decode_scan(cfg, mesh, steps=case["steps"], donate=False,
                                           **kw)
            before = mesh_lib.map_with_specs(lambda x, _: x.clone(), c,
                                             tpd.tp_cache_specs(c))
            tok_kept, _ = kept(p, start, c)
            out["donate_false_kept_cache"] = all(
                torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                for x, y in ((getattr(c, f.name), getattr(before, f.name))
                             for f in dataclasses.fields(c)))
            scan = tpd.make_tp_decode_scan(cfg, mesh, steps=case["steps"], **kw)
            tok, c = scan(p, start, c)
            out["tokens"] = mesh_lib.gather_rows(tok, mesh).numpy()
            out["donate_false_tokens"] = mesh_lib.gather_rows(tok_kept, mesh).numpy()
        else:
            out["logits"] = []
            for tok in tokens:
                lg, c = step(p, mesh_lib.data_rows(tok, mesh), c)
                out["logits"].append(mesh_lib.gather_rows(lg, mesh).numpy())
        whole = mesh_lib.gather_tree(c, tpd.tp_cache_specs(c), mesh)
        out["cache"] = cache_to_numpy(tpd.from_tp_cache(whole, cfg))
        return out
    step, prepare = serving.make_sharded_decode_step(cfg, mesh, tp_params=case["tp_params"])
    p, c = prepare(params, cache)
    out["logits"] = []
    for tok in tokens:
        lg, c = step(p, mesh_lib.data_rows(tok, mesh), c)
        out["logits"].append(mesh_lib.gather_rows(lg, mesh).numpy())
    whole = mesh_lib.gather_tree(c, serving.cache_specs(c), mesh)
    out.update(cache=cache_to_numpy(whole), local_bytes=_nbytes(p), bytes=_nbytes(params))
    return out


def _params_numpy(tree):
    return {k: _params_numpy(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else tree.detach().numpy().copy()


def shard_case(case):
    """One sharded-training case on this rank at mesh (data, model):
    ``steps`` steps of make_sharded_train_step (``zero`` 0-3, ``model``,
    ``fused_ctx``, ``remat``) from the numpy tree ``params`` on the global
    batch ``ids`` with key ``rng`` -> each step's loss and gradient norm,
    every rank's, and the whole tree after the last step (the checkpoint's
    gather, ``checkpoint.train_state_tree``), with the bytes this rank
    holds (parameters and AdamW moments) beside the whole tree's."""
    from backpacks_flash_attn_tpu_torch.training import checkpoint as ckpt
    cfg = (tcfg.BackpackConfig if case["model"] == "backpack" else tcfg.GPTConfig)(**case["cfg"])
    mesh = _tp_mesh(case["data"], case["model_size"])
    params = tl.trainable(params_from_numpy(case["params"], device="cpu"))
    tx = tl.make_optimizer(params, **case["opt"])
    zero = case.get("zero", 0)
    step, init = tl.make_sharded_train_step(
        cfg, tx, mesh, model=case["model"], zero1=zero == 1, zero2=zero == 2,
        zero3=zero == 3, fused_ctx=case.get("fused_ctx"), remat=case.get("remat", "none"))
    state = init(params)
    ids = torch.from_numpy(np.asarray(case["ids"])).long()
    rng = prng.PRNGKey(case["rng"])
    out = {"loss": [], "grad_norm": []}
    for _ in range(case["steps"]):
        state, m = step(state, {"input_ids": ids}, rng)
        out["loss"].append(m["loss"].item())
        out["grad_norm"].append(m["grad_norm"].item())
    tree = ckpt.train_state_tree(state)
    out["params"] = _params_numpy(tree["params"])
    out["mu"] = _params_numpy(tree["opt_state"]["1"]["0"]["mu"])
    opt = state.opt_state
    moments = [t for st in opt.adamw.state.values() for k, t in st.items()
               if k in ("exp_avg", "exp_avg_sq")]
    out["local_bytes"] = {"params": _nbytes(state.params),
                          "moments": sum(t.numel() * t.element_size() for t in moments)}
    out["bytes"] = _nbytes(params)
    return out


def vocab_ce_case(case):
    """vocab_parallel_cross_entropy over the 'model' group of a (data, n)
    mesh: this rank's columns of ``logits``, the loss and the gradient of
    sum(loss * w) in those columns."""
    from backpacks_flash_attn_tpu_torch.ops.cross_entropy import vocab_parallel_cross_entropy
    mesh = _tp_mesh(case["data"], case["model_size"])
    i, n = mesh_lib.coord(mesh, "model")
    logits = torch.from_numpy(np.asarray(case["logits"], np.float32))
    v = logits.shape[-1] // n
    local = logits[..., i * v:(i + 1) * v].clone().requires_grad_()
    loss = vocab_parallel_cross_entropy(local, torch.from_numpy(np.asarray(case["labels"])),
                                        mesh.get_group("model"),
                                        label_smoothing=case["smoothing"])
    (loss * torch.from_numpy(np.asarray(case["w"], np.float32))).sum().backward()
    return {"loss": loss.detach().numpy(), "grad": local.grad.numpy()}


def collectives_case(case):
    """The training collectives of parallel/mesh.py on a (data, model)
    mesh, each on a tensor that names this rank (rank r's x is r + arange),
    backward from an upstream gradient that names it too (r + 1): the
    forward value and the gradient of x, keyed by collective."""
    mesh = _tp_mesh(case["data"], case["model_size"])
    model, data = mesh.get_group("model"), mesh.get_group("data")
    r = torch.distributed.get_rank()
    out = {}
    for name, fn in (("copy_to", lambda x: mesh_lib.copy_to(x, model)),
                     ("reduce_from", lambda x: mesh_lib.reduce_from(x, model)),
                     ("gather_from", lambda x: mesh_lib.gather_from(x, 1, model)),
                     ("gather_scatter", lambda x: mesh_lib.gather_scatter(x, 0, data))):
        x = (r + torch.arange(6.0).reshape(2, 3)).requires_grad_()
        y = fn(x)
        y.backward(torch.full_like(y, float(r + 1)))
        out[name] = (y.detach().numpy(), x.grad.numpy())
    t = r + torch.arange(8.0).reshape(4, 2)
    out["reduce_scatter"] = mesh_lib.reduce_scatter(t, 0, data).numpy()
    out["all_gather_slices"] = mesh_lib.all_gather_slices(t, 1, data).numpy()
    out["group_max"] = mesh_lib.group_max(t, model).numpy()
    return out


def run_cases(cases):
    """Every case of ``cases`` (each {"kind": "ring" | "cp" | "tp" | "shard" |
    "vocab_ce" | "collectives", ...}) in order on this rank; -> their
    results."""
    fns = {"ring": ring_case, "cp": cp_case, "tp": tp_case, "shard": shard_case,
           "vocab_ce": vocab_ce_case, "collectives": collectives_case}
    return [fns[c["kind"]](c) for c in cases]
