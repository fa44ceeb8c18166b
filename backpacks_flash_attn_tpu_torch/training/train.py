"""Training step on one device: AdamW with global-norm clipping and a
warmup-then-decay schedule.

Port of ``backpacks_flash_attn_tpu/training/train.py`` (``_decay_mask`` :31,
``make_schedule`` :45, ``make_optimizer`` :70, ``make_loss_fn`` :97,
``make_train_step`` :122). The optax chain becomes:

  * the decay mask -> two ``torch.optim.AdamW`` parameter groups (weight
    decay on kernels only: biases, norms and embeddings excluded);
  * ``clip_by_global_norm`` -> the same rule on the ``.grad``s in place;
  * the schedule -> the group lr set before every update, read at the
    number of updates so far (optax's count: the lr of the first step is 0
    under warmup).

AdamW keeps its moments in the parameter dtype, as optax does. The step
updates the parameter tensors in place (JAX returns new ones). The sharded,
ZeRO and FSDP steps and ``optax.MultiSteps`` accumulation wait for ROADMAP
Queue 1 item 6.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..models import backpack as bp
from ..models import gpt as gpt_lib
from ..ops.cross_entropy import cross_entropy_loss
from ..utils import prng


def named_leaves(tree, path: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, tensor) for every tensor of a nested-dict tree, in insertion
    order."""
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items()
                for leaf in named_leaves(v, path + (k,))]
    return [(path, tree)]


def decay_mask(params) -> Any:
    """True where weight decay applies (JAX ``_decay_mask`` :31): kernels
    only, not under a norm, not an embedding."""
    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        name = path[-1] if path else ""
        in_norm = any(p in ("norm1", "norm2", "ln_0") for p in path)
        return name == "kernel" and not in_norm

    return walk(params)


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over steps, then end."""
    if steps <= 0:
        return lambda count: init
    return lambda count: ((init - end) * (1.0 - min(max(count, 0), steps) / steps)
                          + end)


def make_schedule(kind: str, *, lr: float, warmup_steps: int,
                  total_steps: int,
                  final_lr_fraction: float = 0.1) -> Callable[[int], float]:
    """Linear warmup from 0, then (JAX ``make_schedule`` :45):
      linear  — linear decay to final_lr_fraction * lr
      cosine  — cosine decay to final_lr_fraction * lr
      invsqrt — lr * sqrt(warmup / step)."""
    decay_steps = max(total_steps - warmup_steps, 1)
    if kind == "linear":
        decay = _linear(lr, lr * final_lr_fraction, decay_steps)
    elif kind == "cosine":
        def decay(count):
            c = min(max(count, 0), decay_steps)
            cos = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
            return lr * ((1.0 - final_lr_fraction) * cos + final_lr_fraction)
    elif kind == "invsqrt":
        w = max(warmup_steps, 1)

        def decay(count):
            return lr * math.sqrt(w / max(count + w, w))
    else:
        raise ValueError(f"unknown schedule {kind!r}")
    warm = _linear(0.0, lr, warmup_steps)
    return lambda count: (warm(count) if count < warmup_steps
                          else decay(count - warmup_steps))


class Optimizer:
    """Global-norm clip, then AdamW with a scheduled lr: the port of the
    optax chain of ``make_optimizer``. Holds ``torch.optim.AdamW`` over two
    parameter groups (decayed kernels first, then the rest)."""

    def __init__(self, params, *, schedule: Callable[[int], float],
                 weight_decay: float, b1: float, b2: float, eps: float,
                 grad_clip: float):
        mask = dict(named_leaves(decay_mask(params)))
        leaves = named_leaves(params)
        self.paths = [p for p, _ in leaves]
        decay = [t for p, t in leaves if mask[p]]
        rest = [t for p, t in leaves if not mask[p]]
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.adamw = torch.optim.AdamW(
            [{"params": decay, "weight_decay": weight_decay},
             {"params": rest, "weight_decay": 0.0}],
            lr=0.0, betas=(b1, b2), eps=eps)
        self.params = [t for _, t in leaves]

    def step(self, count: int) -> torch.Tensor:
        """Clip the ``.grad``s by their global norm (optax's rule: scaled by
        clip / norm when the norm is at least clip), set the lr of update
        ``count``, update in place. Returns the unclipped global norm."""
        for p in self.params:
            if p.grad is None:          # a leaf the loss does not reach
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        if self.grad_clip is not None and self.grad_clip > 0:
            factor = torch.where(gnorm < self.grad_clip, 1.0,
                                 self.grad_clip / gnorm)
            for g in grads:
                g.mul_(factor.to(g.dtype))
        lr = float(self.schedule(count))
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        return gnorm


def make_optimizer(params, *, lr: float = 6e-4, weight_decay: float = 0.1,
                   warmup_steps: int = 1000, total_steps: int = 100_000,
                   b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                   grad_clip: float = 1.0, final_lr_fraction: float = 0.1,
                   accum_steps: int = 1,
                   schedule: str = "linear") -> Optimizer:
    """AdamW with warmup + decay over the tensors of ``params`` (which must
    require grad); schedule as in make_schedule."""
    if accum_steps != 1:
        raise NotImplementedError("gradient accumulation (optax.MultiSteps) "
                                  "is not ported yet (ROADMAP Queue 1 item 6)")
    sched = make_schedule(schedule, lr=lr, warmup_steps=warmup_steps,
                          total_steps=total_steps,
                          final_lr_fraction=final_lr_fraction)
    return Optimizer(params, schedule=sched, weight_decay=weight_decay,
                     b1=b1, b2=b2, eps=eps, grad_clip=grad_clip)


@dataclasses.dataclass
class TrainState:
    """params: the tree of trainable tensors (updated in place);
    opt_state: the Optimizer over them; step: updates taken."""
    params: Any
    opt_state: Optimizer
    step: int = 0


def trainable(params) -> Any:
    """The tree with every floating-point tensor a leaf that requires
    grad (detached from any graph)."""
    if isinstance(params, dict):
        return {k: trainable(v) for k, v in params.items()}
    return params.detach().requires_grad_(params.is_floating_point())


def make_loss_fn(cfg, *, model: str = "backpack",
                 label_smoothing: float = 0.0, remat="none",
                 fused_ctx=None) -> Callable:
    """loss_fn(params, batch, rng) with batch {'input_ids': (b, s + 1)}: the
    LM splits x = ids[:, :-1], y = ids[:, 1:] (JAX :97)."""
    if model == "backpack":
        def fwd(params, x, rng):
            return bp.backpack_forward(params, cfg, x, train=True, rng=rng,
                                       remat=remat, fused_ctx=fused_ctx)
    else:
        def fwd(params, x, rng):
            return gpt_lib.gpt_lm_forward(params, cfg, x, train=True, rng=rng,
                                          remat=remat)

    def loss_fn(params, batch, rng):
        ids = batch["input_ids"]
        x, y = ids[:, :-1], ids[:, 1:]
        return cross_entropy_loss(fwd(params, x, rng), y,
                                  label_smoothing=label_smoothing)

    return loss_fn


def make_train_step(cfg, *, model: str = "backpack", remat="none",
                    fused_ctx=None,
                    label_smoothing: float = 0.0) -> Callable:
    """train_step(state, batch, rng) -> (state, metrics) (JAX :122): the
    step's key is fold_in(rng, state.step); loss and grads by autograd; the
    optimizer updates the parameters in place. metrics: loss, grad_norm
    (before clipping) and ppl, as 0-d tensors."""
    loss_fn = make_loss_fn(cfg, model=model, remat=remat,
                           fused_ctx=fused_ctx,
                           label_smoothing=label_smoothing)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], rng):
        step_rng = prng.fold_in(rng, state.step)
        opt = state.opt_state
        opt.adamw.zero_grad()
        loss = loss_fn(state.params, batch, step_rng)
        loss.backward()
        gnorm = opt.step(state.step)
        loss = loss.detach()
        return (TrainState(state.params, opt, state.step + 1),
                {"loss": loss, "grad_norm": gnorm, "ppl": torch.exp(loss)})

    return train_step
