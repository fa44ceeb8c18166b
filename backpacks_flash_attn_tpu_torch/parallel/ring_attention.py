"""Context-parallel (ring) attention over a mesh's 'seq' dimension.

Port of ``backpacks_flash_attn_tpu/parallel/ring_attention.py``. The
sequence is split over the ranks of a ring (``parallel/mesh.Ring``): rank i
holds q/k/v chunk i (c = s / S rows). At ring step r it holds the K/V of
chunk j = (i - r) mod S, merges its queries' attention against them into
a running online softmax (m, l, acc), and passes the K/V one hop on
(``mesh.hop``: one message a step, through host memory on gloo). After S
steps every query row has seen every key it may attend. Causality across
chunks comes from absolute positions (chunk j's keys at j*c + u against
chunk i's queries at i*c + t): the pairs j > i are fully masked and give
nothing, the bubble the zigzag layout at the bottom removes.

Two inner blocks:

  * ``ring_attention_local`` (impl "einsum"): the scores of one chunk pair
    at a time in f32 einsums, differentiable by autograd through the hops
    (their backward sends gradients the reverse way), each step's block
    under ``torch.utils.checkpoint`` so the backward recomputes its scores
    instead of keeping S of them. Values may be wider than q and k (the
    Backpack contextualization: dnv-wide q/k against d-wide senses).
  * ``ring_flash_attention_local`` (impl "flash"): each pair is one K3
    launch (``ops.flash_attention.flash_fwd``, the pair's k_offsets and
    bh_offset; its plain version on CPU tensors); the pairs' (o_j, lse_j)
    merge in f32. Its backward re-runs the ring feeding each pair's K5
    launch (``flash_bwd``) the GLOBAL out and lse, so p = exp(s - lse) is
    the true softmax restricted to the pair and its gradients are exact
    shares: dq sums locally in f32, the f32 dk/dv sums travel with k/v and
    are home after S hops.

Attention dropout, in either form, hashes GLOBAL (batch row, q position,
k position): with the same key every layout and ring size draws the
single-device kernel's mask. ``dropout_rng`` must be the same on every
rank of the ring; ``bh_offset`` is the global index of local batch row 0
(the data shard's offset).

Past JAX's module: a hop skips the K/V no later step reads (the last
forward step's), the flash rings send the next step's K/V while the
current pair computes (``mesh.start_exchange``), and ``make_ring_attention`` gathers the outputs over the
ring (torch has no global sharded array), so its gradients for the global
inputs are every rank's.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import dropout_keep_positions, flash_bwd, flash_fwd
from ..utils import prng
from . import mesh as mesh_lib
from .mesh import Ring

NEG = -1e30


def _seed(dropout_p: float, dropout_rng) -> tuple:
    """The counter hash's seed words from a ``utils.prng`` key (0, 0 with no
    dropout): the same derivation for the einsum and flash blocks, so both
    draw identical masks from one key."""
    if dropout_p <= 0.0:
        return (0, 0)
    if dropout_rng is None:
        raise ValueError("dropout_p > 0 requires dropout_rng")
    return prng.seed_words(dropout_rng)


def _batch_heads(b: int, h: int, bh_offset: int, device) -> torch.Tensor:
    """The dropout stream (bh_offset + row) * h + head, (b, h, 1, 1)."""
    return ((torch.arange(b, device=device) + int(bh_offset))[:, None] * h
            + torch.arange(h, device=device)[None, :])[:, :, None, None]


def _einsum_block(qf, k, v, m, l, o, *, qpos, kpos, causal, seed, bh,
                  dropout_p):
    """One chunk pair into the running (m, l, o): scores and the softmax in
    f32, the probabilities rounded to v's dtype for the value product (JAX's
    einsum with f32 accumulation)."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf.float(), k.float())
    if causal:
        mask = (kpos[None, :] <= qpos[:, None])[None, None]
    else:
        mask = torch.ones((1, 1, 1, 1), dtype=torch.bool, device=s.device)
    s = torch.where(mask, s, NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    if dropout_p > 0.0:
        keep = dropout_keep_positions(seed, bh, qpos[:, None], kpos[None, :],
                                      dropout_p)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_p)), 0.0)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return m_new, l_new, o * corr[..., None] + pv


def _einsum_ring(q, k, v, ring: Ring, qpos, kpos_of, causal, scale, remat,
                 dropout_p, dropout_rng, bh_offset):
    b, c, h, d = q.shape
    qf = (q.float() * scale).to(q.dtype)
    dev = q.device
    seed = _seed(dropout_p, dropout_rng)
    bh = _batch_heads(b, h, bh_offset, dev)
    m = torch.full((b, h, c), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, c), dtype=torch.float32, device=dev)
    o = torch.zeros((b, h, c, v.shape[-1]), dtype=torch.float32, device=dev)
    k_r, v_r = k, v
    for r in range(ring.size):
        j = (ring.rank - r) % ring.size
        block = functools.partial(_einsum_block, qpos=qpos, kpos=kpos_of(j),
                                  causal=causal, seed=seed, bh=bh,
                                  dropout_p=dropout_p)
        if remat and torch.is_grad_enabled():
            m, l, o = checkpoint(block, qf, k_r, v_r, m, l, o,
                                 use_reentrant=False)
        else:
            m, l, o = block(qf, k_r, v_r, m, l, o)
        if r < ring.size - 1:
            k_r, v_r = mesh_lib.hop(ring, k_r, v_r)
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (o / l_safe[..., None]).to(q.dtype).transpose(1, 2)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, ring: Ring, causal: bool = True,
                         softmax_scale: Optional[float] = None,
                         remat: bool = True, dropout_p: float = 0.0,
                         dropout_rng: Optional[torch.Tensor] = None,
                         bh_offset: int = 0) -> torch.Tensor:
    """The einsum ring on this rank: q, k (b, c, h, d), v (b, c, h, dv)
    local chunks -> (b, c, h, dv) local rows of GLOBAL attention (JAX :71).
    Dropout after the softmax on the un-normalized probabilities, l summing
    them before it (the reference's semantics)."""
    c = q.shape[1]
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    ar = torch.arange(c, device=q.device)
    return _einsum_ring(q, k, v, ring, ring.rank * c + ar, lambda j: j * c + ar,
                        causal, scale, remat, dropout_p, dropout_rng, bh_offset)


# ------------------------------------------------------------ flash ring

def _pair_fwd(q, k, v, causal, qoff, koff, dropout_p, seed, bh_offset):
    """One chunk pair through ``flash_fwd`` (K3 on the card): q, k, v
    (b, c, h, d) -> (o (b, c, h, d), lse (b, h, c))."""
    out, lse = flash_fwd(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), None, 1.0, causal,
                         dropout_p=dropout_p, seed=seed, q_offsets=qoff,
                         k_offsets=koff, bh_offset=bh_offset)
    return out.transpose(1, 2), lse


def _pair_bwd(q, k, v, out, lse, g, causal, qoff, koff, dropout_p, seed,
              bh_offset):
    """One chunk pair's share of the gradients through ``flash_bwd`` (K5 on
    the card), from the rows' GLOBAL out and lse. -> (dq, dk, dv), (b, c,
    h, d)."""
    t = lambda x: x.transpose(1, 2)
    dq, dk, dv, _ = flash_bwd(t(q), t(k), t(v), t(out), lse, t(g), seed, 1.0,
                              causal, dropout_p=dropout_p, q_offsets=qoff,
                              k_offsets=koff, bh_offset=bh_offset)
    return t(dq), t(dk), t(dv)


def _merge(m, l, o, o_j, lse_j):
    """The mesh-level online softmax: o <- o exp(m - m') + o_j exp(lse_j -
    m'); a pair with no valid key (lse_j = NEG_INF) weighs 0."""
    m_new = torch.maximum(m, lse_j)
    corr, w = torch.exp(m - m_new), torch.exp(lse_j - m_new)
    o = (o * corr.transpose(1, 2)[..., None]
         + o_j.float() * w.transpose(1, 2)[..., None])
    return m_new, l * corr + w, o


def _finish(m, l, o, dtype):
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (o / l_safe.transpose(1, 2)[..., None]).to(dtype), m + torch.log(l_safe)


class _RingFlash(torch.autograd.Function):
    """JAX's ``_ring_flash_core`` custom VJP (:138-245) over pre-scaled q."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, dropout_p, seed, bh_offset):
        b, c, h, d = q.shape
        i, S = ring.rank, ring.size
        m = torch.full((b, h, c), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros((b, c, h, d), dtype=torch.float32, device=q.device)
        k_r, v_r = k, v
        for r in range(S):
            j = (i - r) % S
            # the next step's K/V travel while this pair computes
            ex = mesh_lib.start_exchange([k_r, v_r], ring) if r < S - 1 else None
            o_j, lse_j = _pair_fwd(q, k_r, v_r, causal, i * c, j * c,
                                   dropout_p, seed, bh_offset)
            m, l, o = _merge(m, l, o, o_j, lse_j)
            if ex is not None:
                k_r, v_r = mesh_lib.finish_exchange(ex)
        out, lse = _finish(m, l, o, q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (ring, causal, dropout_p, seed, bh_offset)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        ring, causal, dropout_p, seed, bh_offset = ctx.args
        b, c, h, d = q.shape
        i, S = ring.rank, ring.size
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_r, dv_r = torch.zeros_like(dq), torch.zeros_like(dq)
        k_r, v_r = k, v
        for r in range(S):
            j = (i - r) % S
            # k and v travel while the pair computes (a later step reads
            # them); the sums after it, every step (home after S)
            ex = mesh_lib.start_exchange([k_r, v_r], ring) if r < S - 1 else None
            dq_p, dk_p, dv_p = _pair_bwd(q, k_r, v_r, out, lse, g, causal,
                                         i * c, j * c, dropout_p, seed,
                                         bh_offset)
            dq += dq_p.float()
            dk_r += dk_p.float()
            dv_r += dv_p.float()
            dk_r, dv_r = mesh_lib.finish_exchange(
                mesh_lib.start_exchange([dk_r, dv_r], ring, stream=1)) \
                if S > 1 else (dk_r, dv_r)
            if ex is not None:
                k_r, v_r = mesh_lib.finish_exchange(ex)
        return (dq.to(q.dtype), dk_r.to(k.dtype), dv_r.to(v.dtype),
                None, None, None, None, None)


def _prescale(q, softmax_scale):
    """q * scale rounded to q's dtype, outside the autograd Function so that
    autograd carries the scale onto dq (JAX's pattern)."""
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    return (q.float() * scale).to(q.dtype)


def ring_flash_attention_local(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, ring: Ring,
                               causal: bool = True,
                               softmax_scale: Optional[float] = None,
                               dropout_p: float = 0.0,
                               dropout_rng: Optional[torch.Tensor] = None,
                               bh_offset: int = 0) -> torch.Tensor:
    """The flash ring on this rank (JAX :248): q, k, v (b, c, h, d) local
    chunks of equal widths -> (b, c, h, d) local rows of GLOBAL attention,
    with the exact ring backward."""
    return _RingFlash.apply(_prescale(q, softmax_scale), k, v, ring, causal,
                            float(dropout_p), _seed(dropout_p, dropout_rng),
                            int(bh_offset))


# ------------------------------------------------------------ global entry

class _ShardSeq(torch.autograd.Function):
    """This rank's chunk of a global (b, s, ...) tensor along s; the
    backward gathers every rank's chunk gradient, so the global input's
    gradient is whole on every rank."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        c = x.shape[1] // ring.size
        return x[:, ring.rank * c:(ring.rank + 1) * c].contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(mesh_lib.all_gather(g, ctx.ring.group), dim=1), None


class _GatherSeq(torch.autograd.Function):
    """Every rank's chunk joined along s; the backward keeps this rank's
    part of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring, ctx.c = ring, x.shape[1]
        return torch.cat(mesh_lib.all_gather(x, ring.group), dim=1)

    @staticmethod
    def backward(ctx, g):
        i, c = ctx.ring.rank, ctx.c
        return g[:, i * c:(i + 1) * c].contiguous(), None


def make_ring_attention(mesh, *, axis: str = "seq", causal: bool = True,
                        softmax_scale: Optional[float] = None,
                        remat: bool = True, impl: str = "einsum"):
    """attn(q, k, v) over GLOBAL (b, s, h, d) tensors, the same on every
    rank: each rank takes its chunk of the sequence on the ring along
    ``axis`` and the outputs are gathered back (JAX :287, whose shard_map
    keeps them sharded). Differentiable end to end; s must divide by the
    ring's size."""
    ring = mesh_lib.ring_of(mesh, axis)
    if impl == "flash":
        local = functools.partial(ring_flash_attention_local, ring=ring,
                                  causal=causal, softmax_scale=softmax_scale)
    elif impl == "einsum":
        local = functools.partial(ring_attention_local, ring=ring,
                                  causal=causal, softmax_scale=softmax_scale,
                                  remat=remat)
    else:
        raise ValueError(f"unknown ring attention impl: {impl!r}")

    def attn(q, k, v):
        q, k, v = (_ShardSeq.apply(x, ring) for x in (q, k, v))
        return _GatherSeq.apply(local(q, k, v), ring)

    return attn


# ------------------------------------------------------------ zigzag
#
# Each rank owns sequence chunks i and 2S-1-i of width s/(2S), so the causal
# mask leaves every rank the same number of visible keys at every step (the
# plain causal ring's step is its busiest rank's).

def zigzag_order(s: int, S: int) -> torch.Tensor:
    """Permutation p with p[t_new] = t_old: rank i's contiguous shard of the
    permuted sequence is (chunk_i, chunk_{2S-1-i}), chunks of s/(2S)."""
    if s % (2 * S):
        raise ValueError(f"s {s} must divide by 2 x {S}")
    c2 = s // (2 * S)
    idx: List[int] = []
    for i in range(S):
        idx.extend(range(i * c2, (i + 1) * c2))
        idx.extend(range((2 * S - 1 - i) * c2, (2 * S - i) * c2))
    return torch.tensor(idx, dtype=torch.long)


def zigzag_permute(x: torch.Tensor, S: int, axis: int = 1) -> torch.Tensor:
    return torch.index_select(x, axis, zigzag_order(x.shape[axis], S).to(x.device))


def zigzag_unpermute(x: torch.Tensor, S: int, axis: int = 1) -> torch.Tensor:
    order = zigzag_order(x.shape[axis], S)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel())
    return torch.index_select(x, axis, inv.to(x.device))


def _zz_chunks(i: int, S: int):
    return (i, 2 * S - 1 - i)


class _ZigzagFlash(torch.autograd.Function):
    """JAX's ``_zigzag_core`` custom VJP (:366-488): per step the 4 (q
    sub-chunk, kv sub-chunk) pairs, each one K3 (forward) or K5 (backward)
    launch at its absolute offsets; fully masked pairs give exact zeros."""

    @staticmethod
    def forward(ctx, q, k, v, ring, dropout_p, seed, bh_offset):
        b, c, h, d = q.shape
        c2, i, S = c // 2, ring.rank, ring.size
        dev = q.device
        state = [[torch.full((b, h, c2), NEG, dtype=torch.float32, device=dev),
                  torch.zeros((b, h, c2), dtype=torch.float32, device=dev),
                  torch.zeros((b, c2, h, d), dtype=torch.float32, device=dev)]
                 for _ in range(2)]
        k_r, v_r = k, v
        for r in range(S):
            kcs = _zz_chunks((i - r) % S, S)
            ex = mesh_lib.start_exchange([k_r, v_r], ring) if r < S - 1 else None
            for si, qc in enumerate(_zz_chunks(i, S)):
                for ki, kc in enumerate(kcs):
                    sl = slice(ki * c2, (ki + 1) * c2)
                    o_j, lse_j = _pair_fwd(q[:, si * c2:(si + 1) * c2], k_r[:, sl],
                                           v_r[:, sl], True, qc * c2, kc * c2,
                                           dropout_p, seed, bh_offset)
                    state[si] = list(_merge(*state[si], o_j, lse_j))
            if ex is not None:
                k_r, v_r = mesh_lib.finish_exchange(ex)
        parts = [_finish(*st, q.dtype) for st in state]   # (m, l, o) -> (out, lse)
        out = torch.cat([p[0] for p in parts], dim=1)
        lse = torch.cat([p[1] for p in parts], dim=2)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (ring, dropout_p, seed, bh_offset)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        ring, dropout_p, seed, bh_offset = ctx.args
        c2, i, S = q.shape[1] // 2, ring.rank, ring.size
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_r, dv_r = torch.zeros_like(dq), torch.zeros_like(dq)
        k_r, v_r = k, v
        for r in range(S):
            kcs = _zz_chunks((i - r) % S, S)
            ex = mesh_lib.start_exchange([k_r, v_r], ring) if r < S - 1 else None
            for si, qc in enumerate(_zz_chunks(i, S)):
                qs = slice(si * c2, (si + 1) * c2)
                for ki, kc in enumerate(kcs):
                    ks = slice(ki * c2, (ki + 1) * c2)
                    dq_p, dk_p, dv_p = _pair_bwd(
                        q[:, qs], k_r[:, ks], v_r[:, ks], out[:, qs],
                        lse[:, :, qs], g[:, qs], True, qc * c2, kc * c2,
                        dropout_p, seed, bh_offset)
                    dq[:, qs] += dq_p.float()
                    dk_r[:, ks] += dk_p.float()
                    dv_r[:, ks] += dv_p.float()
            dk_r, dv_r = mesh_lib.finish_exchange(
                mesh_lib.start_exchange([dk_r, dv_r], ring, stream=1)) \
                if S > 1 else (dk_r, dv_r)
            if ex is not None:
                k_r, v_r = mesh_lib.finish_exchange(ex)
        return (dq.to(q.dtype), dk_r.to(k.dtype), dv_r.to(v.dtype),
                None, None, None, None)


def zigzag_ring_attention_local(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, ring: Ring,
                                softmax_scale: Optional[float] = None,
                                dropout_p: float = 0.0,
                                dropout_rng: Optional[torch.Tensor] = None,
                                bh_offset: int = 0) -> torch.Tensor:
    """The load-balanced causal flash ring on this rank (JAX :491): local
    ZIGZAG shards (b, 2 * s/(2S), h, d) -> their rows of GLOBAL causal
    attention. Causal only."""
    return _ZigzagFlash.apply(_prescale(q, softmax_scale), k, v, ring,
                              float(dropout_p), _seed(dropout_p, dropout_rng),
                              int(bh_offset))


def make_zigzag_ring_attention(mesh, *, axis: str = "seq",
                               softmax_scale: Optional[float] = None):
    """attn(q, k, v) over GLOBAL (b, s, h, d) tensors in natural order,
    permuted to zigzag order and back around the ring, the outputs gathered
    as :func:`make_ring_attention`'s. s must divide by 2 x the ring's size
    (JAX :521)."""
    ring = mesh_lib.ring_of(mesh, axis)

    def attn(q, k, v):
        q, k, v = (_ShardSeq.apply(zigzag_permute(x, ring.size), ring)
                   for x in (q, k, v))
        out = _GatherSeq.apply(zigzag_ring_attention_local(
            q, k, v, ring=ring, softmax_scale=softmax_scale), ring)
        return zigzag_unpermute(out, ring.size)

    return attn


def zigzag_ring_attention_local_einsum(q: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor, *, ring: Ring,
                                       softmax_scale: Optional[float] = None,
                                       remat: bool = True,
                                       dropout_p: float = 0.0,
                                       dropout_rng: Optional[torch.Tensor] = None,
                                       bh_offset: int = 0) -> torch.Tensor:
    """The einsum zigzag ring (causal, JAX :547): both sub-chunks in one
    block whose mask compares GLOBAL position vectors; values may be wider
    than q and k (the Backpack contextualization)."""
    c = q.shape[1]
    c2, S = c // 2, ring.size
    ar = torch.arange(c2, device=q.device)

    def posvec(j):
        return torch.cat([j * c2 + ar, (2 * S - 1 - j) * c2 + ar])

    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    return _einsum_ring(q, k, v, ring, posvec(ring.rank), posvec, True, scale,
                        remat, dropout_p, dropout_rng, bh_offset)

