"""Training CLI, on one device or sharded over a world of ranks.

Port of ``backpacks_flash_attn_tpu/training/train_cli.py``: mode
train|smoke|profile (smoke runs 3 steps and writes no checkpoint; profile
wraps the steps in ``torch.profiler``), resume from the newest periodic or
crash auto-save checkpoint (parameters, optimizer moments, EMA and the
data sampler's position), speed and metrics logging with the analytic
FLOP count, and the validation perplexity at the end. There is no
``--use-flash``: attention always takes the flash kernels.

A world of ranks, one process each, started by ``parallel/launch.py``
(``--dist-backend``: nccl needs a GPU a rank, gloo runs several ranks on
one card or on the CPU; the default is nccl on cuda, gloo on the CPU);
rank 0 logs and writes the checkpoints:

  * ``--dp M --tp N`` (JAX :128-135): ``training/train.py``'s sharded step
    over a ('data' M, 'model' N) mesh, M x N ranks: the batch split over
    'data', the layers Megatron-sharded over 'model' (heads, MLP columns,
    the vocabulary, the Backpack's senses); ``--zero1``/``--zero2`` shard
    the AdamW moments (and the gradients) over 'data', ``--zero3`` the
    parameters too. A checkpoint holds the whole tree: it resumes at any
    layout (``--tp 1`` included).
  * ``--cp N`` (with ``--dp M``) trains the Backpack model
    context-parallel (JAX :115-126): the sequence split over N ranks of a
    ring (``--cp-layout natural|zigzag``; ``--cp-attn-impl flash|einsum``,
    the GPT attention's inner block), the batch over M. Not with ``--tp``,
    ``--zero*`` or ``--accum-steps``, as in JAX.

``--accum-steps K`` averages K steps' gradients into one update (each
step's batch is one micro-batch); ``--remat none|full|dots``
rematerializes the blocks in the backward (``models/gpt.remat_wrap``).
``--eval-every K`` logs the validation perplexity every K steps (0: at the
end only).

On the CPU a sharded run is a gloo world of processes, e.g. ``--device cpu
--dp 2 --tp 2`` (4 processes). On one GPU, several ranks share the card
over gloo (``--dist-backend gloo``), each hop through host memory.

Usage:
    python -m backpacks_flash_attn_tpu_torch.training.train_cli \\
        --corpus tokens.npy --model backpack-micro --steps 1000 \\
        --batch-size 8 --seqlen 512 --workdir runs/bp-micro \\
        [--dp 2 --tp 2 --zero1 true] [--cp 2] [--accum-steps 4] [--remat full]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
from typing import Any, Dict

import numpy as np
import torch

from .. import config as config_lib
from ..data import lm_dataset as lmd
from ..models import backpack as bp_lib
from ..models import gpt as gpt_lib
from ..ops import _build
from ..utils import prng
from . import callbacks as cb
from . import checkpoint as ckpt_lib
from . import ema as ema_lib
from . import train as train_lib


@dataclasses.dataclass
class RunConfig:
    corpus: str
    workdir: str = "runs/default"
    model: str = "backpack-micro"     # or gpt2-small / *-test
    mode: str = "train"               # train | smoke | profile
    steps: int = 1000
    batch_size: int = 8
    seqlen: int = 512
    lr: float = 6e-4
    lr_schedule: str = "linear"       # linear | cosine | invsqrt
    warmup_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    accum_steps: int = 1
    seed: int = 0
    dp: int = 1
    tp: int = 1
    cp: int = 1                       # context-parallel ring size ('seq')
    cp_layout: str = "natural"        # natural | zigzag (load-balanced)
    cp_attn_impl: str = "flash"       # flash | einsum ring inner block
    dist_backend: str = ""            # nccl | gloo; "" = nccl on cuda, gloo on cpu
    remat: str = "none"               # none | full | dots (models/gpt.remat_wrap)
    zero1: bool = False
    zero2: bool = False
    zero3: bool = False
    ema_decay: float = 0.0            # 0 disables EMA
    ckpt_every: int = 1000
    keep_last: int = 3
    log_every: int = 10
    val_fraction: float = 0.0005      # tail of the corpus held out for ppl
    eval_every: int = 0               # 0 = only at end
    dtype: str = "float32"
    device: str = "cuda"


_MODELS = {
    "backpack-nano": config_lib.backpack_nano,
    "backpack-micro": config_lib.backpack_micro,
    "backpack-mini": config_lib.backpack_mini,
    "backpack-small": config_lib.backpack_small,
    "backpack-test": config_lib.backpack_test,
    "gpt2-small": config_lib.gpt2_small,
    "gpt2-medium": config_lib.gpt2_medium,
    "gpt2-test": config_lib.gpt2_test,
}


def _check_parallel(rc: RunConfig) -> None:
    """CP composes with DP only, as in JAX (:118-120)."""
    if rc.cp > 1 and (rc.tp != 1 or rc.zero1 or rc.zero2 or rc.zero3):
        raise ValueError("--cp composes with --dp only (TP/ZeRO: the sharded "
                         "step, --cp 1)")
    if rc.cp > 1 and not rc.model.startswith("backpack"):
        raise ValueError("--cp drives the Backpack model (as JAX's CLI)")
    if rc.cp > 1 and rc.accum_steps != 1:
        raise ValueError("--cp does not support --accum-steps")
    if rc.remat not in gpt_lib.REMAT_MODES:
        raise ValueError(f"--remat is one of {gpt_lib.REMAT_MODES}, got {rc.remat!r}")
    if rc.cp > 1 and rc.remat != "none":
        raise ValueError("--cp runs without --remat")
    if rc.cp == 1 and rc.dp * rc.tp > 1 and rc.ema_decay > 0:
        raise ValueError("--ema-decay takes a run on one device or --cp (a sharded "
                         "run's parameters are its shards)")


def build_model(rc: RunConfig, device):
    if rc.model not in _MODELS:
        raise SystemExit(f"unknown --model {rc.model!r}; choose from "
                         f"{sorted(_MODELS)}")
    cfg = _MODELS[rc.model]()
    kind = "backpack" if rc.model.startswith("backpack") else "gpt"
    init = bp_lib.init_backpack if kind == "backpack" else gpt_lib.init_gpt
    gen = torch.Generator().manual_seed(rc.seed)
    params = init(cfg, gen, dtype=config_lib.DTYPE_MAP[rc.dtype],
                  device=device)
    return cfg, kind, params


def _backend(rc: RunConfig) -> str:
    if rc.dist_backend:
        return rc.dist_backend
    return "gloo" if rc.device == "cpu" else "nccl"


def _run_rank(fields: Dict[str, Any]) -> Dict[str, Any]:
    """One rank of a --cp or sharded world (parallel/launch.py's target)."""
    return run(RunConfig(**fields))


class _Quiet:
    """The metrics logger of a rank other than 0: logs nothing."""

    def log(self, step, metrics):
        pass

    def close(self):
        pass


def run(rc: RunConfig) -> Dict[str, Any]:
    _check_parallel(rc)
    world = rc.dp * (rc.cp if rc.cp > 1 else rc.tp)
    if world > 1 and not torch.distributed.is_initialized():
        from ..parallel import launch
        return launch.run_world(
            "backpacks_flash_attn_tpu_torch.training.train_cli:_run_rank",
            world, args=(dataclasses.asdict(rc),), backend=_backend(rc),
            timeout=float("inf"), inherit_rank0=True)[0]
    lead = world == 1 or torch.distributed.get_rank() == 0
    device = _build.resolve_device(rc.device)
    if world > 1 and device.type == "cuda" and _backend(rc) == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    os.makedirs(rc.workdir, exist_ok=True)
    tokens = lmd.load_corpus(rc.corpus)
    n_val = max(int(len(tokens) * rc.val_fraction), rc.seqlen + 1)
    train_tokens, val_tokens = tokens[:-n_val], tokens[-n_val:]

    cfg, kind, params = build_model(rc, device)
    params = train_lib.trainable(params)
    opt = train_lib.make_optimizer(
        params, lr=rc.lr, weight_decay=rc.weight_decay,
        warmup_steps=rc.warmup_steps, total_steps=rc.steps,
        grad_clip=rc.grad_clip, accum_steps=rc.accum_steps,
        schedule=rc.lr_schedule)
    if rc.cp > 1:
        from ..parallel import cp_train as cp_lib
        from ..parallel import mesh as mesh_lib
        mesh = mesh_lib.make_cp_mesh(rc.dp, rc.cp)
        step_fn, init = cp_lib.make_cp_sharded_train_step(
            cfg, opt, mesh, attn_impl=rc.cp_attn_impl, layout=rc.cp_layout)
        state = init(params)
    elif world > 1:
        from ..parallel import mesh as mesh_lib
        mesh = mesh_lib.make_mesh(rc.dp, rc.tp)
        step_fn, init = train_lib.make_sharded_train_step(
            cfg, opt, mesh, model=kind, remat=rc.remat, zero1=rc.zero1,
            zero2=rc.zero2, zero3=rc.zero3)
        state = init(params)
    else:
        state = train_lib.TrainState(params, opt, 0)
        step_fn = train_lib.make_train_step(cfg, model=kind, remat=rc.remat)
    sampler = lmd.SamplerState(seed=rc.seed)
    ema = ema_lib.init_ema(params) if rc.ema_decay > 0 else None

    def current_state():
        tree = {"state": ckpt_lib.train_state_tree(state)}
        return tree | ({"ema": ckpt_lib.ema_tree(ema)} if ema else {})

    start_step = 0
    latest = ckpt_lib.latest_checkpoint(rc.workdir)
    if latest and rc.mode == "train":
        restored, start_step, meta = ckpt_lib.restore(latest, current_state())
        ckpt_lib.load_train_state(state, restored["state"])
        if ema is not None:
            ckpt_lib.load_ema(ema, restored["ema"])
        s = meta.get("sampler", {})
        sampler = lmd.SamplerState(seed=s.get("seed", rc.seed),
                                   epoch=s.get("epoch", 0),
                                   counter=s.get("counter", 0))
        if lead:
            print(f"resumed from {latest} at step {start_step}")

    steps = 3 if rc.mode == "smoke" else rc.steps
    logger = (cb.MetricsLogger(os.path.join(rc.workdir, "metrics.jsonl"),
                               print_every=rc.log_every) if lead else _Quiet())
    speed = cb.SpeedMonitor()
    ds = lmd.LMDataset(train_tokens, rc.seqlen)
    stream = lmd.batches(ds, rc.batch_size, sampler)
    rng = prng.PRNGKey(rc.seed + 1)
    logger.log(start_step, {"flops_per_step": cb.flop_count(
        cfg, params, rc.batch_size, rc.seqlen)})

    from ..eval.perplexity import evaluate_perplexity
    if kind == "backpack":
        def fwd(p, x):
            return bp_lib.backpack_forward(p, cfg, x)
    else:
        def fwd(p, x):
            return gpt_lib.gpt_lm_forward(p, cfg, x)
    # a sharded state's whole tree is a gather, which every rank joins: so
    # every rank takes part in the checkpoints and validations (rank 0
    # writes and evaluates), and there is no crash auto-save (a failed
    # rank would not join it)
    sharded = getattr(state.opt_state, "sharding", None) is not None

    def validate(at: int) -> Dict[str, float]:
        params_now = (ema.shadow if ema is not None
                      else ckpt_lib.train_state_tree(state)["params"] if sharded
                      else state.params)
        if not lead:
            return {}
        val = evaluate_perplexity(fwd, val_tokens, rc.seqlen,
                                  min(rc.batch_size, 4), max_batches=50,
                                  params=params_now, device=device)
        logger.log(at, {f"val/{k}": v for k, v in val.items()})
        return val

    def checkpoint(at: int) -> None:
        tree = current_state()
        if lead:
            ckpt_lib.save(rc.workdir, tree, step=at,
                          meta={"sampler": dataclasses.asdict(sampler)},
                          keep_last=rc.keep_last)

    prof = None
    if rc.mode == "profile":
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()

    metrics: Dict[str, Any] = {}
    with (ckpt_lib.auto_save_on_exception(
            rc.workdir, current_state, lambda: state.step,
            meta={"sampler": dataclasses.asdict(sampler)})
          if lead and not sharded else contextlib.nullcontext()):
        for i in range(start_step, steps):
            pre = speed.on_step_start()
            (x, y), sampler = next(stream)
            # the loss fn splits ids[:, :-1] / ids[:, 1:]: rebuild the
            # (b, L + 1) window from (x, y)
            window = np.concatenate([x, y[:, -1:]], axis=1)
            batch = {"input_ids": torch.from_numpy(window).long().to(device)}
            state, metrics = step_fn(state, batch, rng)
            if ema is not None:
                ema = ema_lib.ema_update(ema, state.params, rc.ema_decay)
            if device.type == "cuda":
                torch.cuda.synchronize()
            post = speed.on_step_end(tokens_in_batch=x.size)
            if i % rc.log_every == 0 or i == steps - 1:
                logged = {k: float(v) for k, v in metrics.items()}
                logged.update(pre)
                logged.update(post)
                logger.log(i, logged)
            if rc.mode == "train" and rc.ckpt_every and (i + 1) % rc.ckpt_every == 0:
                checkpoint(i + 1)
            if rc.eval_every and (i + 1) % rc.eval_every == 0 and i + 1 < steps:
                validate(i + 1)

    if prof is not None:
        prof.stop()
    if prof is not None and lead:
        trace = os.path.join(rc.workdir, "profile_trace.json")
        prof.export_chrome_trace(trace)
        sort = ("self_cuda_time_total" if device.type == "cuda"
                else "self_cpu_time_total")
        print(prof.key_averages().table(sort_by=sort, row_limit=10))
        print(f"profile written to {trace}")

    final = {k: float(v) for k, v in metrics.items()}
    if rc.mode == "train":
        checkpoint(steps)
    val = validate(steps)
    logger.close()
    return {"final_metrics": final, "val": val, "steps": steps}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for f in dataclasses.fields(RunConfig):
        flag = "--" + f.name.replace("_", "-")
        if isinstance(f.default, bool):
            p.add_argument(flag, type=lambda s: s.lower() in ("1", "true"),
                           default=f.default)
        elif f.default is dataclasses.MISSING:
            p.add_argument(flag, type=str, required=True)
        else:
            p.add_argument(flag, type=type(f.default), default=f.default)
    args = p.parse_args(argv)
    print(run(RunConfig(**vars(args))))


if __name__ == "__main__":
    main()
