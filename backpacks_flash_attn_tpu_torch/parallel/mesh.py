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


def shard_tensor(t: torch.Tensor, spec: Spec, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's slice of ``t`` under ``spec``: each named dimension cut
    into as many equal chunks as the mesh dimension has ranks, chunk =
    this rank's coordinate (a contiguous copy)."""
    for dim, name in enumerate(spec):
        if name is None:
            continue
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
    for dim, name in enumerate(spec):
        if name is not None and coord(mesh, name)[1] > 1:
            t = torch.cat(all_gather(t, mesh.get_group(name)), dim=dim)
    return t


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
