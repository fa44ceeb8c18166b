"""Device meshes, parameter specs and the ring over ``torch.distributed``.

The port of ``backpacks_flash_attn_tpu/parallel/mesh.py``: ``make_mesh``
(:30), the ('data', 'model') mesh of tensor-parallel serving
(``parallel/tp_decode.py``, ``parallel/serving.py``), beside the ('data',
'seq') mesh that context-parallel training builds (``parallel/cp_train.py``,
``training/train_cli.py:115-126``), and the Megatron parameter specs
(:39-160). JAX's mesh is a grid of devices under one controller; here it is
a grid of ranks, one process each, laid out with ``init_device_mesh`` over
a process group that the caller (or ``parallel/launch.py``) has
initialized. A mesh spans the whole world.

A spec is a tuple with one mesh-dimension name or None per leading
dimension of a tensor, as JAX's ``PartitionSpec`` is (the dimensions past
its end are replicated). JAX's ``device_put`` with such shardings becomes
``shard_params`` (each rank keeps its own slices) and the all-gathers XLA
inserts become ``gather_params``.

The backend is the caller's: NCCL where each rank has a GPU of its own,
gloo otherwise (several ranks on one card, or the CPU). gloo carries only
CPU tensors, so on gloo every collective here stages a CUDA tensor
through host memory (``host_staged``); nothing picks a backend because
another failed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import BackpackConfig, GPTConfig
from ..ops.quant import QuantTable, QuantWeight

# the ring's hops in this process: count, bytes, and the host's seconds
# in them: "seconds", staging and posting a hop and then waiting for it,
# of which "wait_seconds" is the wait for the message (the peer's send and
# the transfer). The device work queued before a staged hop is waited for
# before its span starts, and work launched between posting and waiting
# overlaps the transfer, so neither is counted. chip_smoke's cp phase reads
# them as "ms a step in hops"; reset by reset_hop_stats
HOP_STATS = {"hops": 0, "bytes": 0, "seconds": 0.0, "wait_seconds": 0.0}


def reset_hop_stats() -> None:
    HOP_STATS.update(hops=0, bytes=0, seconds=0.0, wait_seconds=0.0)


def host_staged() -> bool:
    """Whether collectives stage CUDA tensors through host memory: the
    world's backend is gloo."""
    return dist.get_backend() == "gloo"


def _mesh_device() -> str:
    return "cpu" if host_staged() else "cuda"


def make_cp_mesh(data: int = 1, seq: int = 1) -> DeviceMesh:
    """The context-parallel mesh: ('data', 'seq'), data * seq ranks (the
    world's size); rank r sits at (r // seq, r % seq), so the ranks of one
    ring are consecutive."""
    return init_device_mesh(_mesh_device(), (data, seq),
                            mesh_dim_names=("data", "seq"))


def make_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """The serving mesh: ('data', 'model'), data * model ranks (the world's
    size); rank r sits at (r // model, r % model), so the ranks of one
    tensor-parallel ring are consecutive."""
    return init_device_mesh(_mesh_device(), (data, model),
                            mesh_dim_names=("data", "model"))


def coord(mesh: DeviceMesh, dim: str) -> Tuple[int, int]:
    """This rank's (index, size) along mesh dimension ``dim``."""
    return mesh.get_local_rank(dim), mesh.size(mesh.mesh_dim_names.index(dim))


@dataclasses.dataclass(frozen=True)
class Ring:
    """The ring along one mesh dimension: this rank's index and the ring's
    size, the global ranks it sends to (``nxt``) and receives from
    (``prv``), and the group. JAX's ``lax.ppermute`` with perm
    [(r, r + 1 mod S)]."""
    group: dist.ProcessGroup
    rank: int
    size: int
    nxt: int
    prv: int


def ring_of(mesh: DeviceMesh, dim: str = "seq") -> Ring:
    group = mesh.get_group(dim)
    ranks = dist.get_process_group_ranks(group)
    i, n = coord(mesh, dim)
    return Ring(group, i, n, ranks[(i + 1) % n], ranks[(i - 1) % n])


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])


# a message is sent in pieces of about this many bytes (at most MAX_PIECES),
# each its own send with its own tag: gloo keeps several pieces of a large
# message in flight at once
PIECE_BYTES, MAX_PIECES = 16 << 20, 64


@dataclasses.dataclass
class Exchange:
    """A hop in flight (``start_exchange``): the requests, the receive
    buffer and what to unpack it into."""
    reqs: list
    recv: torch.Tensor
    like: List[Tuple[torch.Size, torch.dtype]]
    device: torch.device


def _pieces(t: torch.Tensor) -> int:
    return max(1, min(MAX_PIECES, -(-t.numel() // PIECE_BYTES)))


def start_exchange(tensors: Sequence[torch.Tensor], ring: Ring,
                   reverse: bool = False, stream: int = 0) -> Exchange:
    """Post one hop of the ring: ``tensors`` to the next rank (the previous
    one when ``reverse``), as one message in pieces; on gloo a CUDA message
    is staged through pinned host memory. The caller may launch work on
    the device before ``finish_exchange``, which overlaps the transfer.
    ``stream``: which of the hops in flight at once this is (their pieces
    carry tags of their own)."""
    dst, src = (ring.prv, ring.nxt) if reverse else (ring.nxt, ring.prv)
    staged = tensors[0].is_cuda and host_staged()
    if staged:
        # the work queued before the hop is the caller's, not the hop's
        torch.cuda.current_stream(tensors[0].device).synchronize()
    t0 = time.perf_counter()
    flat = _pack(tensors)
    if staged:
        send = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        send.copy_(flat, non_blocking=True)
        torch.cuda.current_stream(flat.device).synchronize()
        recv = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
    else:
        send, recv = flat, torch.empty_like(flat)
    n = _pieces(send)
    tag = stream * MAX_PIECES
    ops = [op for i, (a, b) in enumerate(zip(send.chunk(n), recv.chunk(n)))
           for op in (dist.P2POp(dist.isend, a, dst, ring.group, tag=tag + i),
                      dist.P2POp(dist.irecv, b, src, ring.group, tag=tag + i))]
    reqs = dist.batch_isend_irecv(ops)
    HOP_STATS["hops"] += 1
    HOP_STATS["bytes"] += send.numel()
    HOP_STATS["seconds"] += time.perf_counter() - t0
    return Exchange(reqs, recv, [(t.shape, t.dtype) for t in tensors], flat.device)


def finish_exchange(ex: Exchange) -> List[torch.Tensor]:
    """Wait for a posted hop and return the tensors received, on the
    device they were sent from."""
    t0 = time.perf_counter()
    for req in ex.reqs:
        req.wait()
    waited = time.perf_counter() - t0
    recv = ex.recv.to(ex.device, non_blocking=True)
    HOP_STATS["wait_seconds"] += waited
    HOP_STATS["seconds"] += time.perf_counter() - t0
    out, o = [], 0
    for shape, dtype in ex.like:
        n = shape.numel() * torch.empty((), dtype=dtype).element_size()
        out.append(recv[o:o + n].view(dtype).reshape(shape))
        o += n
    return out


def exchange(tensors: Sequence[torch.Tensor], ring: Ring,
             reverse: bool = False) -> List[torch.Tensor]:
    """One hop of the ring (``start_exchange`` then ``finish_exchange``):
    send ``tensors`` to the next rank (the previous one when ``reverse``)
    and return those received from the other side. A ring of one rank
    returns the tensors."""
    if ring.size == 1:
        return list(tensors)
    return finish_exchange(start_exchange(tensors, ring, reverse))


class _Hop(torch.autograd.Function):
    """A differentiable hop: its backward sends the gradients the reverse
    way (the transpose of JAX's ppermute)."""

    @staticmethod
    def forward(ctx, ring, *tensors):
        ctx.ring = ring
        ctx.like = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(exchange(tensors, ring))

    @staticmethod
    def backward(ctx, *grads):
        grads = [g if g is not None else torch.zeros(s, dtype=dt, device=dv)
                 for g, (s, dt, dv) in zip(grads, ctx.like)]
        return (None, *exchange(grads, ctx.ring, reverse=True))


def hop(ring: Ring, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The tensors of the previous rank of the ring (each rank sends its
    own to the next), differentiable in them."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _Hop.apply(ring, *tensors)
    return tuple(exchange(tensors, ring))


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the group (the world by default) in place; on gloo a
    CUDA tensor goes through host memory."""
    if t.is_cuda and host_staged():
        buf = t.cpu()
        dist.all_reduce(buf, group=group)
        t.copy_(buf)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape everywhere), in group-rank order; on
    gloo through host memory."""
    n = dist.get_world_size(group)
    src = t.detach().contiguous()
    staged = src.is_cuda and host_staged()
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts] if staged else parts


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``t`` from global rank ``src`` into every rank's ``t``, in place."""
    if t.is_cuda and host_staged():
        buf = t.detach().cpu()
        dist.broadcast(buf, src, group=group)
        t.data.copy_(buf)
    else:
        dist.broadcast(t.data, src, group=group)
    return t


# ---------------------------------------------------------------- training collectives
#
# The sharded train step's collectives (``training/train.py``): Megatron's
# three autograd regions over the 'model' group, and the 'data' group's
# reduce-scatter and all-gather of slices for ZeRO. They are built on
# all_reduce_ and all_gather above, so on gloo a CUDA tensor goes through
# host memory, and each counts as one hop in HOP_STATS (the device work
# queued before it is waited for first, as a staged ring hop's is).


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _counted(t: torch.Tensor, nbytes: int, fn):
    """fn() as one hop of HOP_STATS moving nbytes."""
    if t.is_cuda and host_staged():
        torch.cuda.current_stream(t.device).synchronize()
    t0 = time.perf_counter()
    out = fn()
    dt = time.perf_counter() - t0
    HOP_STATS["hops"] += 1
    HOP_STATS["bytes"] += nbytes
    HOP_STATS["seconds"] += dt
    HOP_STATS["wait_seconds"] += dt
    return out


def group_sum(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: ``t`` summed over the group, in t's dtype (bf16 and
    f16 sum in f32, then round once)."""
    buf = t.detach().float() if t.dtype in (torch.bfloat16, torch.float16) else \
        t.detach().clone()
    _counted(buf, buf.numel() * buf.element_size(), lambda: all_reduce_(buf, group))
    return buf.to(t.dtype)


def group_max(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: the elementwise max of ``t`` over the group."""
    buf = t.detach().clone()
    if buf.is_cuda and host_staged():
        host = buf.cpu()
        _counted(buf, host.numel() * host.element_size(),
                 lambda: dist.all_reduce(host, op=dist.ReduceOp.MAX, group=group))
        return host.to(buf.device)
    _counted(buf, buf.numel() * buf.element_size(),
             lambda: dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group))
    return buf


def all_gather_slices(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's slice of a tensor split along ``dim`` (the same shape on
    every rank), concatenated in group-rank order: the whole tensor."""
    n = _group_size(group)
    if n == 1:
        return t
    parts = _counted(t, t.numel() * t.element_size() * n,
                     lambda: all_gather(t, group))
    return torch.cat(parts, dim=dim)


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along ``dim`` of ``t`` summed over the group (the
    slices in group-rank order; the dim must divide). On gloo, which has no
    reduce-scatter, an all-reduce and the slice (twice the bytes); on NCCL
    ``reduce_scatter_tensor``."""
    n = _group_size(group)
    if n == 1:
        return t
    i = dist.get_rank(group)
    c = t.shape[dim] // n
    if host_staged() or not t.is_cuda:
        return group_sum(t, group).narrow(dim, i * c, c).contiguous()
    src = t.detach().movedim(dim, 0).contiguous()
    out = torch.empty((c, *src.shape[1:]), dtype=src.dtype, device=src.device)
    _counted(src, src.numel() * src.element_size(),
             lambda: dist.reduce_scatter_tensor(out, src, group=group))
    return out.movedim(0, dim).contiguous()


class _CopyTo(torch.autograd.Function):
    """Megatron's f: the identity forward, the gradient summed over the
    group backward (the input of a column-parallel region)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return group_sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: the partial sums summed over the group forward, the
    identity backward (the output of a row-parallel region)."""

    @staticmethod
    def forward(ctx, x, group):
        return group_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """Every rank's slice along ``dim`` gathered forward, this rank's slice
    of the gradient backward (the gathered tensor feeds replicated work,
    whose gradient is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return all_gather_slices(x.contiguous(), dim, group)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None


class _GatherScatter(torch.autograd.Function):
    """ZeRO-3's gather of a parameter's 'data' slices: all-gather forward,
    the gradient reduce-scattered backward (each rank's gradient differs:
    its own rows)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_slices(x.detach().contiguous(), dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


def _mm(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """a @ b over the last dims, accumulated in f32 and rounded to dtype
    (bf16 operands and result: one bf16 product, as the single-device
    linears make it)."""
    a2 = a.reshape(-1, a.shape[-1])
    out = a2 @ b if a2.dtype == b.dtype == dtype == torch.bfloat16 else \
        (a2.float() @ b.float()).to(dtype)
    return out.reshape(*a.shape[:-1], b.shape[-1])


class _ColumnLinear(torch.autograd.Function):
    """A column-parallel linear with Megatron's f fused in: y = x @ W + b
    in x's dtype (the single-device product); backward, dW and db as
    autograd makes them, and dx's partial products (this rank's columns)
    in f32, summed over the group in f32 and rounded once, so that no
    rank's partial is rounded to bf16 before the sum."""

    @staticmethod
    def forward(ctx, x, w, b, group):
        ctx.save_for_backward(x, w)
        ctx.group, ctx.b_dtype = group, None if b is None else b.dtype
        y = _mm(x, w, x.dtype)
        if b is not None:
            y = y + b.to(y.dtype) if y.dtype == torch.bfloat16 else \
                (y.float() + b.float()).to(y.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = group_sum(g2.float() @ w.float().t(), ctx.group).to(x.dtype)
        dw = _mm(x.reshape(-1, x.shape[-1]).t(), g2.to(x.dtype), w.dtype)
        db = None if ctx.b_dtype is None else g2.float().sum(0).to(ctx.b_dtype)
        return dx.reshape(x.shape), dw, db, None


class _RowPartial(torch.autograd.Function):
    """This rank's partial product of a row-parallel linear, x @ W_rows,
    in f32 (summed over the group before it is rounded); backward dx and
    dW in the operands' dtype, as the single-device product's."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm(x, w, torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dw = _mm(x.reshape(-1, x.shape[-1]).t(), g.reshape(-1, g.shape[-1]), w.dtype)
        return _mm(g, w.t(), x.dtype), dw


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if _group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if _group_size(group) == 1 else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if _group_size(group) == 1 else _GatherFrom.apply(x, dim % x.dim(), group)


def gather_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if _group_size(group) == 1 else _GatherScatter.apply(x, dim % x.dim(), group)


@dataclasses.dataclass(frozen=True)
class Shard:
    """Where a rank's part of a sharded training step sits (the models'
    ``shard=`` argument): the 'model' group (None: no tensor parallelism),
    this rank's index in it and its size, and the global index of this
    rank's first batch row (its 'data' shard). The forward then computes
    ``n_head / size`` heads, ``num_senses / size`` senses, vocab-sharded
    logits, and every dropout mask of the unsharded step."""
    group: Any = None
    rank: int = 0
    size: int = 1
    row_offset: int = 0

    @property
    def tp(self) -> bool:
        return self.size > 1

    def reduce_from(self, x):
        return reduce_from(x, self.group) if self.tp else x

    def gather_from(self, x, dim: int):
        return gather_from(x, dim, self.group) if self.tp else x

    def column(self, x, p):
        """A column-parallel linear {'kernel', 'bias'?} of this rank's
        columns on the replicated x (:class:`_ColumnLinear`)."""
        return _ColumnLinear.apply(x, p["kernel"], p.get("bias"), self.group)

    def row(self, x, p):
        """A row-parallel linear: this rank's rows of the kernel on its
        slice of x, the f32 partials summed over the group and rounded to
        x's dtype once, the bias added after (as the single-device
        linear adds it)."""
        y = reduce_from(_RowPartial.apply(x, p["kernel"]), self.group).to(x.dtype)
        b = p.get("bias")
        if b is None:
            return y
        return y + b.to(y.dtype) if y.dtype == torch.bfloat16 else \
            (y.float() + b.float()).to(y.dtype)

    def token_index(self, b: int, s: int, d: int, device) -> Optional[torch.Tensor]:
        """The flat positions of this rank's (b, s, d) elements in the
        unsharded (B, s, d) tensor, which the per-token dropout sites hash
        (None for the first data shard: its own positions)."""
        if self.row_offset == 0:
            return None
        rows = torch.arange(b, device=device) + self.row_offset
        pos = rows[:, None] * s + torch.arange(s, device=device)[None, :]
        return pos[:, :, None] * d + torch.arange(d, device=device)


def shard_of(mesh: DeviceMesh, rows_per_rank: int = 0) -> Shard:
    """This rank's :class:`Shard` on a ('data', 'model') mesh, its data
    shard ``rows_per_rank`` rows."""
    i, n = coord(mesh, "model")
    di, _ = coord(mesh, "data")
    return Shard(mesh.get_group("model") if n > 1 else None, i, n, di * rows_per_rank)


# ---------------------------------------------------------------- specs

Spec = Tuple[Optional[str], ...]


def _linear_spec(col_parallel: bool, stacked: bool) -> Dict[str, Spec]:
    """Megatron TP: column-parallel shards the out dim (bias too);
    row-parallel shards the in dim with a replicated bias (JAX :39)."""
    lead = (None,) if stacked else ()
    if col_parallel:
        return {"kernel": (*lead, None, "model"), "bias": (*lead, "model")}
    return {"kernel": (*lead, "model", None), "bias": (*lead, None)}


def _norm_spec(stacked: bool) -> Dict[str, Spec]:
    lead = (None,) if stacked else ()
    return {"weight": lead, "bias": lead}


def gpt_param_specs(cfg: GPTConfig, params: Optional[Any] = None) -> Dict:
    """The spec tree of a GPT parameter tree (JAX :54): vocab-sharded word
    embeddings and a dim-sharded position table, Wqkv and fc1
    column-parallel, out_proj and fc2 row-parallel. MoE blocks (expert
    parallelism) wait for ROADMAP Queue 1 item 7b."""
    if cfg.moe_experts > 0:
        raise NotImplementedError("expert-parallel MoE specs are not ported "
                                  "yet (ROADMAP Queue 1 item 7b)")
    return {
        "wte": ("model", None),
        "wpe": (None, "model"),
        "ln_0": _norm_spec(False),
        "layers": {
            "Wqkv": _linear_spec(True, True),
            "out_proj": _linear_spec(False, True),
            "norm1": _norm_spec(True),
            "norm2": _norm_spec(True),
            "mlp": {"fc1": _linear_spec(True, True),
                    "fc2": _linear_spec(False, True)},
        },
    }


def backpack_param_specs(cfg: BackpackConfig) -> Dict:
    """Backpack TP (JAX :89): the contextualization Wqkv column-parallel
    over the nv heads, the sense network's final d -> nv * d expansion
    column-parallel over senses, its no-mix block like an MLP."""
    return {
        "gpt": gpt_param_specs(cfg),
        "ctx_attn": {"Wqkv": _linear_spec(True, False)},
        "content": {
            "ln_0": _norm_spec(False),
            "blocks": {
                "norm1": _norm_spec(True),
                "mlp": {"fc1": _linear_spec(True, True),
                        "fc2": _linear_spec(False, True)},
                "norm2": _norm_spec(True),
            },
            "final_mlp": {"fc1": _linear_spec(True, False),
                          "fc2": _linear_spec(True, False)},
        },
    }


def replicated(tree: Any) -> Any:
    """The all-replicated spec tree of ``tree``: () for every tensor."""
    if isinstance(tree, dict):
        return {k: replicated(v) for k, v in tree.items()}
    if isinstance(tree, QuantWeight):
        return dataclasses.replace(tree, q=(), scale=(),
                                   bias=None if tree.bias is None else ())
    if isinstance(tree, QuantTable):
        return dataclasses.replace(tree, q=(), scale=())
    return None if tree is None else ()


def _match_spec_to_params(params: Any, specs: Any) -> Any:
    """The spec tree pruned and extended to the parameter tree (JAX :112):
    specs of absent parameters dropped (no wpe), anything unspecified
    replicated, a QuantWeight's q and scale sharded as its kernel's out
    dim, a QuantTable over its rows, the INT8 embedding's {'q',
    'row_scale'} over rows and an explicit lm_head over its vocab
    columns."""
    if isinstance(params, QuantWeight):
        kspec = specs["kernel"] if isinstance(specs, dict) else specs
        out_axis, lead = kspec[-1], tuple(kspec[:-2])
        return QuantWeight(q=(*lead, kspec[-2], out_axis),
                           scale=(*lead, None, out_axis),
                           bias=(*lead, out_axis) if params.bias is not None else None,
                           bits=params.bits, d_out=params.d_out)
    if isinstance(params, QuantTable):
        return QuantTable(q=("model", None, None), scale=("model", None, None),
                          bits=params.bits)
    if isinstance(params, dict):
        out = {}
        for k, v in params.items():
            if isinstance(specs, dict) and k in specs:
                out[k] = _match_spec_to_params(v, specs[k])
            elif k in ("q", "row_scale"):       # the quantized embedding dict
                out[k] = ("model", None)
            elif k == "lm_head":
                out[k] = _match_spec_to_params(v, {"kernel": (None, "model")})
            elif k == "table":
                out[k] = _match_spec_to_params(v, None)
            else:
                out[k] = replicated(v)
        return out
    if isinstance(specs, dict):
        # a bare leaf where the specs hold a dict (an absent bias): replicated
        return ()
    return specs if specs is not None else replicated(params)


def param_specs(params: Any, cfg: GPTConfig) -> Any:
    """The spec tree of a (possibly quantized) GPT or Backpack tree (JAX
    ``param_shardings`` :149)."""
    base = (backpack_param_specs(cfg) if isinstance(cfg, BackpackConfig)
            else gpt_param_specs(cfg))
    return _match_spec_to_params(params, base)


def map_with_specs(fn, tree: Any, specs: Any) -> Any:
    """``fn(tensor, spec)`` on every tensor of ``tree`` beside its spec in
    ``specs`` (the same structure; dataclasses such as QuantWeight and the
    caches field by field); other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, v, specs[k]) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_with_specs(fn, getattr(tree, f.name), getattr(specs, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _names(entry) -> Tuple[str, ...]:
    """The mesh dimensions of one spec entry: None, a name, or a tuple of
    names (the dimension split over the first, each chunk over the next,
    as JAX's P(('model', 'data')))."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_tensor(t: torch.Tensor, spec: Spec, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's slice of ``t`` under ``spec``: each named dimension cut
    into as many equal chunks as the mesh dimension has ranks, chunk =
    this rank's coordinate (a contiguous copy)."""
    for dim, entry in enumerate(spec):
        for name in _names(entry):
            i, n = coord(mesh, name)
            if t.shape[dim] % n:
                raise ValueError(f"dimension {dim} of a {tuple(t.shape)} tensor does "
                                 f"not divide over the {n} ranks of mesh dimension "
                                 f"{name!r}")
            c = t.shape[dim] // n
            t = t.narrow(dim, i * c, c)
    return t.contiguous().clone() if spec and any(spec) else t


def gather_tensor(t: torch.Tensor, spec: Spec, mesh: DeviceMesh) -> torch.Tensor:
    """The inverse of :func:`shard_tensor`: the slices of every rank of
    each named mesh dimension, concatenated in coordinate order."""
    for dim, entry in enumerate(spec):
        for name in reversed(_names(entry)):
            if coord(mesh, name)[1] > 1:
                t = torch.cat(all_gather(t, mesh.get_group(name)), dim=dim)
    return t


def spec_names(spec: Spec) -> Tuple[str, ...]:
    """Every mesh dimension a spec shards over."""
    return tuple(n for entry in spec for n in _names(entry))


def with_data(spec: Spec, dim: int) -> Spec:
    """``spec`` with dimension ``dim`` also split over 'data' (after any
    name it has)."""
    parts = list(spec) + [None] * (dim + 1 - len(spec))
    parts[dim] = _names(parts[dim]) + ("data",) if parts[dim] is not None else "data"
    return tuple(parts)


def _packs_major(x: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """The last axis from (a, b, rest)-major to (b, a, rest)-major."""
    y = x.reshape(*x.shape[:-1], a, b, x.shape[-1] // (a * b))
    return y.transpose(-3, -2).reshape(x.shape)


def train_layout(params: Any, cfg: GPTConfig, tp: int, inverse: bool = False) -> Any:
    """The packed projections' out columns reordered so that the 'model'
    rank r's contiguous chunk (``shard_tensor`` of the column-parallel
    spec) holds its groups in the unsharded packing: the GPT Wqkv's (3,
    n_head, head_dim) columns become (tp, 3, n_head / tp, head_dim)-major,
    the contextualization Wqkv's (2, nv, dnv) (tp, 2, nv / tp, dnv)-major.
    Rank r then holds q, k and v of heads [r h / tp, (r + 1) h / tp) in
    the (3, h / tp, dh) order the forward reshapes. inverse: back to the
    unsharded layout. A new tree (the other leaves shared); tp 1 is the
    identity."""
    if tp == 1:
        return params
    a_b = lambda packs: (tp, packs) if inverse else (packs, tp)

    def lin(p, packs):
        return {k: _packs_major(v, *a_b(packs)) for k, v in p.items()}

    gp = params["gpt"] if "gpt" in params else params
    out_gp = dict(gp, layers=dict(gp["layers"], Wqkv=lin(gp["layers"]["Wqkv"], 3)))
    if "gpt" not in params:
        return out_gp
    return dict(params, gpt=out_gp,
                ctx_attn=dict(params["ctx_attn"], Wqkv=lin(params["ctx_attn"]["Wqkv"], 2)))


def shard_tree(tree: Any, specs: Any, mesh: DeviceMesh) -> Any:
    """:func:`shard_tensor` on every tensor of ``tree`` beside its spec."""
    return map_with_specs(lambda t, s: shard_tensor(t, s, mesh), tree, specs)


def gather_tree(tree: Any, specs: Any, mesh: DeviceMesh) -> Any:
    """:func:`gather_tensor` on every tensor of ``tree`` beside its spec."""
    return map_with_specs(lambda t, s: gather_tensor(t, s, mesh), tree, specs)


def shard_params(params: Any, cfg: GPTConfig, mesh: DeviceMesh) -> Any:
    """This rank's slices of each leaf under :func:`param_specs` (JAX
    ``shard_params`` :158, which device_puts the tree with those
    shardings). A QuantWeight keeps its bits and d_out: its slices are
    rest storage for :func:`gather_params`, not a weight of their own."""
    return shard_tree(params, param_specs(params, cfg), mesh)


def gather_params(params: Any, cfg: GPTConfig, mesh: DeviceMesh) -> Any:
    """The whole tree from every rank's :func:`shard_params` slices (the
    all-gathers over the mesh's groups that XLA inserts in JAX's pjit
    path)."""
    return gather_tree(params, param_specs(params, cfg), mesh)


def data_rows(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows (dim 0) of a global batch: its 'data' shard."""
    return shard_tensor(x, ("data",), mesh)


def gather_rows(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The global batch from every 'data' shard's rows (dim 0)."""
    return gather_tensor(x, ("data",), mesh)
