"""Training step, on one device or sharded over a mesh of ranks: AdamW with
global-norm clipping and a warmup-then-decay schedule.

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
updates the parameter tensors in place (JAX returns new ones).
``make_optimizer(accum_steps=k)`` is ``optax.MultiSteps`` (:87).

The DP x TP step (``make_sharded_train_step`` :206, with
``zero1_opt_shardings`` :155 and ``fsdp_param_shardings`` :177) runs one
process a rank over a ('data', 'model') mesh of ``parallel/mesh.py``: each
rank holds its Megatron slices of the parameters and computes its data
shard's rows and its heads, columns and senses
(``parallel.mesh.Shard``); ZeRO-1/2 keep each AdamW moment's 'data' slice,
ZeRO-3 the parameters' too, gathered a layer at a time in the forward and
again in the backward (saved-tensor hooks). A checkpoint holds the whole
tree (``training/checkpoint.py`` gathers it and shards it back).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..models import backpack as bp
from ..models import gpt as gpt_lib
from ..ops.cross_entropy import cross_entropy_loss, vocab_parallel_cross_entropy
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


def local_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """The global norm of a list of gradients (f32)."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


class Optimizer:
    """Global-norm clip, then AdamW with a scheduled lr: the port of the
    optax chain of ``make_optimizer``. Holds ``torch.optim.AdamW`` over two
    parameter groups (decayed kernels first, then the rest).

    accum_steps k > 1 is ``optax.MultiSteps`` (JAX :87): each call adds its
    gradients to their running mean, and every k-th call the clip and
    AdamW run on the mean (the schedule reads the updates taken, not the
    calls). ``norm``: how the global norm of a gradient list is taken (a
    sharded step's reads every rank's shard, ``make_sharded_train_step``)."""

    def __init__(self, params, *, schedule: Callable[[int], float],
                 weight_decay: float, b1: float, b2: float, eps: float,
                 grad_clip: float, accum_steps: int = 1,
                 norm: Callable[[List[torch.Tensor]], torch.Tensor] = local_norm):
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be at least 1, got {accum_steps}")
        mask = dict(named_leaves(decay_mask(params)))
        leaves = named_leaves(params)
        self.paths = [p for p, _ in leaves]
        decay = [t for p, t in leaves if mask[p]]
        rest = [t for p, t in leaves if not mask[p]]
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.hparams = dict(schedule=schedule, weight_decay=weight_decay, b1=b1,
                            b2=b2, eps=eps, grad_clip=grad_clip,
                            accum_steps=accum_steps)
        self.adamw = torch.optim.AdamW(
            [{"params": decay, "weight_decay": weight_decay},
             {"params": rest, "weight_decay": 0.0}],
            lr=0.0, betas=(b1, b2), eps=eps)
        self.params = [t for _, t in leaves]
        self.accum_steps = accum_steps
        self.mini_step = 0      # calls into the current accumulation
        self.acc = None         # the running mean of their gradients
        self.norm = norm
        self.updated = False    # whether the last call updated the parameters

    def update_count(self) -> int:
        """The updates taken (optax's count; AdamW's step)."""
        for state in self.adamw.state.values():
            if "step" in state:
                return int(state["step"])
        return 0

    def step(self, count: Optional[int] = None) -> torch.Tensor:
        """Clip the ``.grad``s by their global norm (optax's rule: scaled by
        clip / norm when the norm is at least clip), set the lr of update
        ``count`` (by default the updates taken so far), update in place;
        under accumulation only every accum_steps-th call, on the mean of
        the calls' gradients. Returns the unclipped global norm of this
        call's gradients."""
        for p in self.params:
            if p.grad is None:          # a leaf the loss does not reach
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        gnorm = self.norm(grads)
        self.updated = False
        clip_norm = gnorm
        if self.accum_steps > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            if n < self.accum_steps - 1:
                self.mini_step += 1
                return gnorm
            self.mini_step = 0
            for g, a in zip(grads, self.acc):
                g.copy_(a)
                a.zero_()
            clip_norm = self.norm(grads)
        if self.grad_clip is not None and self.grad_clip > 0:
            factor = torch.where(clip_norm < self.grad_clip, 1.0,
                                 self.grad_clip / clip_norm)
            for g in grads:
                g.mul_(factor.to(g.dtype))
        lr = float(self.schedule(self.update_count() if count is None else count))
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.updated = True
        return gnorm


def make_optimizer(params, *, lr: float = 6e-4, weight_decay: float = 0.1,
                   warmup_steps: int = 1000, total_steps: int = 100_000,
                   b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                   grad_clip: float = 1.0, final_lr_fraction: float = 0.1,
                   accum_steps: int = 1,
                   schedule: str = "linear") -> Optimizer:
    """AdamW with warmup + decay over the tensors of ``params`` (which must
    require grad); schedule as in make_schedule; accum_steps > 1 averages
    that many calls' gradients into one update (``optax.MultiSteps``)."""
    sched = make_schedule(schedule, lr=lr, warmup_steps=warmup_steps,
                          total_steps=total_steps,
                          final_lr_fraction=final_lr_fraction)
    return Optimizer(params, schedule=sched, weight_decay=weight_decay,
                     b1=b1, b2=b2, eps=eps, grad_clip=grad_clip,
                     accum_steps=accum_steps)


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
                 fused_ctx=None, shard=None) -> Callable:
    """loss_fn(params, batch, rng) with batch {'input_ids': (b, s + 1)}: the
    LM splits x = ids[:, :-1], y = ids[:, 1:] (JAX :97). shard
    (``parallel.mesh.Shard``): the batch is this rank's data shard and the
    forward its part of the sharded step; with tensor parallelism the loss
    is the vocab-parallel cross-entropy of its logit columns (the same
    mean loss on every rank of the 'model' group)."""
    if model == "backpack":
        def fwd(params, x, rng):
            return bp.backpack_forward(params, cfg, x, train=True, rng=rng,
                                       remat=remat, fused_ctx=fused_ctx,
                                       shard=shard)
    else:
        def fwd(params, x, rng):
            return gpt_lib.gpt_lm_forward(params, cfg, x, train=True, rng=rng,
                                          remat=remat, shard=shard)

    def loss_fn(params, batch, rng):
        ids = batch["input_ids"]
        x, y = ids[:, :-1], ids[:, 1:]
        logits = fwd(params, x, rng)
        if shard is None or not shard.tp:
            return cross_entropy_loss(logits, y, label_smoothing=label_smoothing)
        per_token = vocab_parallel_cross_entropy(logits, y, shard.group,
                                                 label_smoothing=label_smoothing)
        return per_token.sum() / torch.clamp((y != -100).sum(), min=1)

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
        gnorm = opt.step()
        loss = loss.detach()
        return (TrainState(state.params, opt, state.step + 1),
                {"loss": loss, "grad_norm": gnorm, "ppl": torch.exp(loss)})

    return train_step


# ---------------------------------------------------------------- sharded

def _stacked(path: Tuple[str, ...]) -> bool:
    """Whether a leaf is layer-stacked (dim 0 its layer): under a GPT
    tree's 'layers' or the sense network's 'blocks'."""
    return "layers" in path or "blocks" in path


def _map_leaves(fn, tree, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def zero1_opt_shardings(tree, mesh) -> Any:
    """ZeRO-1 (JAX :155): the 'data' spec of each leaf of ``tree`` (an
    optimizer moment's shape): its first dimension that the data size
    divides (and is at least), else replicated (()). The port applies it
    to a rank's tensor-parallel slice of each leaf."""
    from ..parallel import mesh as mesh_lib
    dn = mesh_lib.coord(mesh, "data")[1]

    def spec(_, t):
        if dn > 1:
            for axis, dim in enumerate(t.shape):
                if dim >= dn and dim % dn == 0:
                    return (None,) * axis + ("data",)
        return ()

    return _map_leaves(spec, tree)


def fsdp_param_shardings(params, cfg, mesh) -> Any:
    """ZeRO-3/FSDP (JAX :177): each parameter's tensor-parallel spec
    (``parallel.mesh.param_specs``) with 'data' on its first free axis that
    the data size divides. A layer-stacked leaf's layer axis is not taken
    (JAX's rule may take it): each layer is sliced over 'data', so the
    forward gathers one layer at a time."""
    from ..parallel import mesh as mesh_lib
    base = mesh_lib.param_specs(params, cfg)
    dn = mesh_lib.coord(mesh, "data")[1]

    def widen(path, t):
        spec = _get(base, path)
        if dn <= 1:
            return spec
        parts = list(spec) + [None] * (t.dim() - len(spec))
        for axis in range(1 if _stacked(path) else 0, t.dim()):
            if parts[axis] is None and t.shape[axis] >= dn and t.shape[axis] % dn == 0:
                return mesh_lib.with_data(tuple(parts), axis)
        return spec

    return _map_leaves(widen, params)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _data_dim(spec) -> Optional[int]:
    for dim, entry in enumerate(spec):
        if entry == "data" or (isinstance(entry, tuple) and "data" in entry):
            return dim
    return None


@dataclasses.dataclass
class _Leaf:
    """One parameter of a sharded step. ``param``: the rank's stored
    tensor, its place in the global tensor ``spec`` (tensor parallelism,
    and 'data' under ZeRO-3 at ``fsdp_dim``). ``opt``: the tensor the
    optimizer updates, at ``opt_spec``: the parameter itself, or under
    ZeRO-1/2 a copy of its 'data' slice along ``slice_dim``. ``replicas``:
    the ranks that hold the same optimizer gradient."""
    path: Tuple[str, ...]
    param: torch.Tensor
    spec: tuple
    opt: torch.Tensor
    opt_spec: tuple
    slice_dim: Optional[int]
    fsdp_dim: Optional[int]
    replicas: int


class _Stack:
    """A layer-stacked ZeRO-3 leaf in the forward's tree: layer i
    (``models.gpt.tree_index``) is gathered over 'data' when the forward
    takes it. ``shape``: the whole stacked tensor's."""

    def __init__(self, local: torch.Tensor, dim: int, dn: int, gather):
        self.local, self.dim, self.gather = local, dim, gather
        shape = list(local.shape)
        shape[dim + 1] *= dn
        self.shape = torch.Size(shape)

    def __getitem__(self, i):
        return self.gather(self.local[i], self.dim)


class Sharding:
    """What a sharded step's optimizer knows of its parameters (the
    ``sharding`` of the Optimizer that ``make_sharded_train_step``'s init
    builds): the mesh, the ZeRO stage, each leaf (:class:`_Leaf`)."""

    def __init__(self, cfg, mesh, zero: int, leaves: List[_Leaf]):
        from ..parallel import mesh as mesh_lib
        self.cfg, self.mesh, self.zero, self.leaves = cfg, mesh, zero, leaves
        self.di, self.dn = mesh_lib.coord(mesh, "data")
        self.mi, self.tp = mesh_lib.coord(mesh, "model")
        self.data_group = mesh.get_group("data") if self.dn > 1 else None
        self.model_group = mesh.get_group("model") if self.tp > 1 else None
        self._gathered: Dict[int, tuple] = {}

    # ---- the forward's tree (ZeRO-3: gathered a layer at a time)

    def _gather(self, local: torch.Tensor, dim: int) -> torch.Tensor:
        import weakref

        from ..parallel import mesh as mesh_lib
        full = mesh_lib.gather_scatter(local, dim, self.data_group)
        self._gathered[full.untyped_storage().data_ptr()] = (weakref.ref(full), local, dim)
        return full

    def _pack(self, t: torch.Tensor):
        hit = self._gathered.get(t.untyped_storage().data_ptr()) if t.numel() else None
        if hit is None or hit[0]() is None:
            return t
        return ("gathered", hit[1], hit[2], t.shape, t.stride(), t.storage_offset())

    def _unpack(self, x):
        if not isinstance(x, tuple):
            return x
        from ..parallel import mesh as mesh_lib
        _, local, dim, shape, stride, offset = x
        full = mesh_lib.all_gather_slices(local.detach().contiguous(), dim, self.data_group)
        return full.as_strided(shape, stride, offset)

    def forward_tree(self, params):
        """(the tree the forward reads, the context to run it in). Under
        ZeRO-3 every 'data'-sliced leaf is gathered when it is used (a
        layer at a time for the stacked ones), and a gathered tensor that
        the backward needs is not kept: saved-tensor hooks gather it again
        there. Otherwise the parameters and no context."""
        import contextlib
        if self.zero != 3 or self.dn == 1:
            return params, contextlib.nullcontext()
        self._gathered.clear()
        by_path = {leaf.path: leaf for leaf in self.leaves}

        def view(path, t):
            leaf = by_path[path]
            if leaf.fsdp_dim is None:
                return t
            if _stacked(path):
                return _Stack(t, leaf.fsdp_dim - 1, self.dn, self._gather)
            return self._gather(t, leaf.fsdp_dim)

        return (_map_leaves(view, params),
                torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack))

    # ---- gradients and updates

    def _sum_flat(self, tensors: List[torch.Tensor]) -> None:
        """Each tensor summed over 'data' in place, one message a dtype."""
        from ..parallel import mesh as mesh_lib
        by_dtype: Dict[torch.dtype, list] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = mesh_lib.group_sum(torch.cat([t.reshape(-1) for t in ts]), self.data_group)
            o = 0
            for t in ts:
                t.copy_(flat[o:o + t.numel()].view_as(t))
                o += t.numel()

    def reduce_grads(self) -> None:
        """The optimizer tensors' gradients from the parameters': summed
        over 'data' (ZeRO-0/1 all-reduce; ZeRO-2 reduce-scatters the sliced
        leaves; ZeRO-3's sliced leaves were reduce-scattered by their
        gathers' backward), and under ZeRO-1/2 cut to the slice."""
        from ..parallel import mesh as mesh_lib
        for leaf in self.leaves:
            if leaf.param.grad is None:
                leaf.param.grad = torch.zeros_like(leaf.param)
        if self.dn == 1:
            for leaf in self.leaves:
                if leaf.opt is not leaf.param:
                    leaf.opt.grad = leaf.param.grad
            return
        summed = [l for l in self.leaves
                  if not (self.zero == 2 and l.slice_dim is not None)
                  and not (self.zero == 3 and l.fsdp_dim is not None)]
        self._sum_flat([l.param.grad for l in summed])
        for leaf in self.leaves:
            if leaf.slice_dim is None:
                continue
            g = leaf.param.grad
            if self.zero == 2:
                leaf.opt.grad = mesh_lib.reduce_scatter(g, leaf.slice_dim, self.data_group)
            else:
                c = g.shape[leaf.slice_dim] // self.dn
                leaf.opt.grad = g.narrow(leaf.slice_dim, self.di * c, c).clone()
            leaf.param.grad = None

    @torch.no_grad()
    def publish(self) -> None:
        """ZeRO-1/2: every rank's updated slices all-gathered into the
        parameters."""
        from ..parallel import mesh as mesh_lib
        for leaf in self.leaves:
            if leaf.slice_dim is not None:
                leaf.param.copy_(mesh_lib.all_gather_slices(leaf.opt, leaf.slice_dim,
                                                            self.data_group))

    def norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of the optimizer tensors' gradients (in leaf
        order) over every rank: each rank's squares divided by the ranks
        holding the same gradient, summed over the world."""
        from ..parallel import mesh as mesh_lib
        sq = torch.stack([g.double().square().sum() / leaf.replicas
                          for g, leaf in zip(grads, self.leaves)]).sum()
        if self.dn * self.tp > 1:
            sq = mesh_lib.group_sum(sq, None)
        return torch.sqrt(sq).float()

    # ---- checkpoints: the global tree

    def global_tree(self, tensors: List[torch.Tensor], opt: bool) -> dict:
        """The whole tree, in the unsharded layout, of per-leaf tensors
        shaped as each leaf's parameter (opt False) or optimizer tensor
        (opt True): a gather that every rank joins."""
        from ..parallel import mesh as mesh_lib
        out = [mesh_lib.gather_tensor(t.detach(), l.opt_spec if opt else l.spec, self.mesh)
               for t, l in zip(tensors, self.leaves)]
        tree = _tree_from([l.path for l in self.leaves], out)
        return mesh_lib.train_layout(tree, self.cfg, self.tp, inverse=True)

    def local_tensors(self, tree: dict, opt: bool) -> List[torch.Tensor]:
        """The inverse of :meth:`global_tree`: this rank's slice of each
        leaf of a whole tree, in leaf order."""
        from ..parallel import mesh as mesh_lib
        tree = mesh_lib.train_layout(tree, self.cfg, self.tp)
        return [mesh_lib.shard_tensor(_get(tree, l.path), l.opt_spec if opt else l.spec,
                                      self.mesh) for l in self.leaves]

    def state_tree(self, state) -> dict:
        """The JAX TrainState tree of a sharded state, whole on every rank
        (``training/checkpoint.train_state_tree``): params, AdamW's moments
        and count, step."""
        opt = state.opt_state
        moments = {}
        for name, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            moments[name] = self.global_tree(
                [opt.adamw.state.get(l.opt, {}).get(key, torch.zeros_like(l.opt))
                 for l in self.leaves], opt=True)
        params = self.global_tree([l.param for l in self.leaves], opt=False)
        return _state_tree(params, moments["mu"], moments["nu"], opt.update_count(),
                           state.step)

    @torch.no_grad()
    def load_state_tree(self, state, tree: dict) -> None:
        """The inverse of :meth:`state_tree`: this rank's slices of a
        restored global tree into ``state`` in place."""
        opt = state.opt_state
        adam = tree["opt_state"]["1"]["0"]
        count = int(adam["count"])
        for l, p in zip(self.leaves, self.local_tensors(tree["params"], opt=False)):
            l.param.copy_(p.to(l.param.device))
        for l, p in zip(self.leaves, self.local_tensors(tree["params"], opt=True)):
            if l.opt is not l.param:
                l.opt.copy_(p.to(l.opt.device))
        mus, nus = self.local_tensors(adam["mu"], opt=True), self.local_tensors(adam["nu"], opt=True)
        for l, mu, nu in zip(self.leaves, mus, nus):
            opt.adamw.state[l.opt] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu.to(device=l.opt.device, dtype=l.opt.dtype),
                "exp_avg_sq": nu.to(device=l.opt.device, dtype=l.opt.dtype)}
        state.step = int(tree["step"])


def _tree_from(paths, tensors) -> dict:
    out: dict = {}
    for path, t in zip(paths, tensors):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def _state_tree(params, mu, nu, count: int, step: int) -> dict:
    """The JAX TrainState's tree (optax's chain: the clip's empty state,
    AdamW's count and moments, the schedule's count)."""
    import numpy as np
    count = np.int32(count)
    adam = {"count": count, "mu": mu, "nu": nu}
    return {"params": params,
            "opt_state": {"0": {}, "1": {"0": adam, "1": {}, "2": {"count": count}}},
            "step": np.int32(step)}


def make_sharded_train_step(cfg, tx: Optimizer, mesh, *, model: str = "backpack",
                            zero1: bool = False, zero2: bool = False,
                            zero3: bool = False, remat="none", fused_ctx=None,
                            label_smoothing: float = 0.0):
    """The DP x TP train step over a ('data', 'model') mesh (JAX :206),
    one process a rank. Returns (step, sharded_init):

      sharded_init(params) -> TrainState: the whole tree (the same on every
        rank) -> this rank's parameters: the Megatron slices of
        ``parallel.mesh.param_specs`` over 'model' (the packed projections
        laid out by ``mesh.train_layout``), under ZeRO-3 also sliced over
        'data' (``fsdp_param_shardings``); and an Optimizer with ``tx``'s
        settings over what this rank updates.
      step(state, batch, rng) -> (state, {'loss', 'grad_norm', 'ppl'}):
        batch {'input_ids': (B, s + 1)} the GLOBAL batch, of which this
        rank takes its 'data' shard's rows; the key fold_in(rng,
        state.step) and every dropout mask the unsharded step's (the rows'
        global index, the heads' offset); the loss the global mean, the
        gradient norm the global gradient's (each shard's squares counted
        once).

    zero1: each AdamW moment kept as this rank's slice of its parameter's
    first dimension the data size divides (``zero1_opt_shardings``): the
    gradients are summed over 'data', each rank updates its slice and the
    slices are all-gathered into the parameters. zero2: as zero1, the
    gradients reduce-scattered to the slices. zero3: the parameters
    themselves kept sliced over 'data', all-gathered a layer at a time in
    the forward and again in the backward, the gradients reduce-scattered
    by the gathers' backward; the moments follow the slices. remat and
    fused_ctx as the single-device forward's. On gloo every collective
    stages a CUDA tensor through host memory (``parallel/mesh.py``)."""
    from ..parallel import mesh as mesh_lib
    zero = 3 if zero3 else 2 if zero2 else 1 if zero1 else 0
    di, dn = mesh_lib.coord(mesh, "data")
    tp = mesh_lib.coord(mesh, "model")[1]

    def sharded_init(params) -> TrainState:
        specs = (fsdp_param_shardings(params, cfg, mesh) if zero == 3
                 else mesh_lib.param_specs(params, cfg))
        # a leaf no mesh dimension slices is the caller's tensor: copied, so
        # that the updates leave the caller's tree as it was
        local = trainable(_map_leaves(
            lambda path, t: t if mesh_lib.spec_names(_get(specs, path)) else t.clone(),
            mesh_lib.shard_tree(mesh_lib.train_layout(params, cfg, tp), specs, mesh)))
        leaves = []
        for path, t in named_leaves(local):
            spec = _get(specs, path)
            slice_dim = None
            if zero in (1, 2):
                slice_dim = _data_dim(_get(zero1_opt_shardings({"t": t}, mesh), ("t",)))
            opt_t, opt_spec = t, spec
            if slice_dim is not None:
                c = t.shape[slice_dim] // dn
                opt_t = t.detach().narrow(slice_dim, di * c, c).clone().requires_grad_()
                opt_spec = mesh_lib.with_data(spec, slice_dim)
            names = mesh_lib.spec_names(opt_spec)
            replicas = ((1 if "model" in names else tp)
                        * (1 if "data" in names else dn))
            leaves.append(_Leaf(path, t, spec, opt_t, opt_spec, slice_dim,
                                _data_dim(spec) if zero == 3 else None, replicas))
        sharding = Sharding(cfg, mesh, zero, leaves)
        opt = Optimizer(_tree_from([l.path for l in leaves], [l.opt for l in leaves]),
                        **dict(tx.hparams, norm=sharding.norm))
        opt.sharding = sharding
        return TrainState(local, opt, 0)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], rng):
        opt = state.opt_state
        sharding = opt.sharding
        ids = batch["input_ids"]
        if ids.shape[0] % dn:
            raise ValueError(f"batch {ids.shape[0]} must divide by the data size {dn}")
        b = ids.shape[0] // dn
        shard = mesh_lib.shard_of(mesh, b)
        loss_fn = make_loss_fn(cfg, model=model, label_smoothing=label_smoothing,
                               remat=remat, fused_ctx=fused_ctx, shard=shard)
        for leaf in sharding.leaves:
            leaf.param.grad = None
            leaf.opt.grad = None
        tree, hooks = sharding.forward_tree(state.params)
        with hooks:
            loss = loss_fn(tree, {"input_ids": ids[di * b:(di + 1) * b]},
                           prng.fold_in(rng, state.step))
        (loss / dn).backward()
        del tree
        sharding.reduce_grads()
        gnorm = opt.step()
        if opt.updated:
            sharding.publish()
        loss = loss.detach()
        if dn > 1:
            loss = mesh_lib.group_sum(loss, sharding.data_group) / dn
        return (TrainState(state.params, opt, state.step + 1),
                {"loss": loss, "grad_norm": gnorm, "ppl": torch.exp(loss)})

    return step, sharded_init
