"""Device meshes and the ring over ``torch.distributed``.

The port's counterpart of ``backpacks_flash_attn_tpu/parallel/mesh.py``'s
``make_mesh`` (:30) for the ('data', 'seq') mesh that context-parallel
training builds (``parallel/cp_train.py``, ``training/train_cli.py:115-126``);
its ('data', 'model') form comes with the tensor-parallel slice. JAX's mesh
is a grid of devices under one controller; here it is a grid of ranks, one
process each, laid out with ``init_device_mesh`` over a process group that
the caller (or ``parallel/launch.py``) has initialized. A mesh spans the
whole world.

The backend is the caller's: NCCL where each rank has a GPU of its own,
gloo otherwise (several ranks on one card, or the CPU). gloo carries only
CPU tensors, so on gloo every collective here stages a CUDA tensor
through host memory (``host_staged``); nothing picks a backend because
another failed. The TP parameter specs of JAX's module (:39-160) come with
the tensor-parallel slice (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

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
