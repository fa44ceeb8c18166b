"""FlashAttention forward (kernel K3) and backward (kernel K5).

Port of ``backpacks_flash_attn_tpu/ops/flash_attention.py``
(``flash_attention`` :1039 -> ``_flash_fwd`` :298 -> ``_flash_fwd_kernel``
:158, and the ``custom_vjp`` around it, :1009-1036, whose backward is
``_flash_bwd`` :794) for causal masking, per-sequence ``seq_lengths`` and
``q_offsets``, and attention dropout: key column u of sequence b is valid
when ``u < min(seq_lengths[b], sk)`` and, if causal, ``u <= q_offsets[b] -
k_offsets[b] + i`` for query row i. Fully masked rows give 0 and an LSE of
``NEG_INF``.

Dropout keeps a probability where the counter hash of ``(seed, (bh_offset
+ b)*H + h, q_offsets[b] + i, k_offsets[b] + j)`` falls below a threshold (``dropout_keep_positions``,
JAX :120), so the forward, the backward and the plain versions all draw the
same mask without storing it. A tensor-parallel rank's head shard, heads
``[head_offset, head_offset + h)`` of ``global_heads``, hashes the stream
``(bh_offset + b) * global_heads + head_offset + h``: the slice of the
unsharded call's mask. It is applied to the un-normalised
probabilities after the running max and sum, so the LSE stays the one of
the softmax before dropout (JAX :250-259).

The differentiable entry (no ``seq_lengths``/``q_offsets``, as in JAX)
saves ``(q, k, v, out, lse)``, the bias and the seed; its backward is K5 on
the card and :func:`flash_attention_bwd_ref` on the CPU. The ragged/offset
entry is inference only on the card, as in JAX: there it raises when a
gradient would be asked for (its plain version, eager PyTorch, stays
differentiable).

An additive f32 score bias ``attn_bias`` (b|1, h|1, sq, sk) or (sq, sk)
(JAX :1039-1115, :350-370) is added to the scaled scores before the masks
and the running max, so the LSE includes it and masked keys stay masked;
its gradient is ``dbias = p * (dp_kept - delta)`` (JAX :488-511), 0 on the
pairs the masks or the causal skip leave out, summed over the broadcast
dims in Python and cast to the bias's dtype (JAX :1021-1031).

The ring forms (``k_offsets``, ``bh_offset``, and K5 at sq != sk with
``q_offsets``): :func:`flash_fwd` and :func:`flash_bwd` at JAX's
``_flash_fwd``/``_flash_bwd`` signatures, the building blocks of
``parallel/ring_attention.py``: a chunk pair of a sequence split over ranks
is masked by its relative offset and hashed at its absolute positions, so
the pairs' merged outputs and summed gradients are the whole sequence's.

Block-sparse attention (kernel K9) is :func:`flash_blocksparse_attention`
(JAX :1415): the same online softmax over only the (block_q, block_k) tiles
a blockmask marks, forward through ``_bs_fwd`` (:1185) and backward through
``_bs_bwd_rule`` (:1362).

The kernels are built for head dims 64, 80, 96 and 128 (the repo's
configurations' head dims). Any other head dim up to 128 is padded with
zero columns to the next of them and the outputs are cut back, as JAX's
``_head_pad`` (:78) pads to a multiple of 128: the scores, the softmax and
the kept columns are unchanged, and the scale is the true head dim's.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import prng
from . import _build

# Large negative instead of -inf: keeps exp(m_prev - m_new) finite for
# fully-masked tiles.
NEG_INF = -0.7 * float(np.finfo(np.float32).max)
DROPOUT_ROUNDS = 2
_K3 = _build.KERNELS["flash_attention"]
_K5 = _build.KERNELS["flash_attention_bwd"]
_K9 = _build.KERNELS["blocksparse_fwd"]
_K9_BWD = _build.KERNELS["blocksparse_bwd"]


def _per_seq(x, b: int, device, default: int) -> torch.Tensor:
    if x is None:
        return torch.full((b,), default, dtype=torch.int64, device=device)
    return torch.as_tensor(x, device=device).reshape(-1).expand(b)


# ------------------------------------------------------------ dropout hash

def keep_threshold(dropout_p: float) -> int:
    """The 32-bit threshold a hash must fall below to keep (JAX :145)."""
    return min(int(round((1.0 - dropout_p) * 2 ** 32)), 2 ** 32 - 1)


def dropout_keep_positions(seed: Tuple[int, int], bh, q_pos, k_pos,
                           dropout_p: float,
                           rounds: int = DROPOUT_ROUNDS) -> torch.Tensor:
    """Counter-based keep mask of ``_dropout_keep_positions`` (JAX :120):
    the murmur finalizer over ``(seed, bh, q_pos, k_pos)``, which broadcast
    together. uint32 arithmetic in int64 masked to 32 bits."""
    m = prng.MASK32
    u = lambda t: torch.as_tensor(t, dtype=torch.int64) & m
    x = (seed[0] ^ prng.mul32(u(q_pos), 0x9E3779B9)
         ^ prng.mul32(u(k_pos), 0x85EBCA77) ^ prng.mul32(u(bh), 0xC2B2AE3D))
    x = (x + seed[1]) & m
    for _ in range(rounds):
        x = x ^ (x >> 16)
        x = prng.mul32(x, 0x85EBCA6B)
        x = x ^ (x >> 13)
        x = prng.mul32(x, 0xC2B2AE35)
        x = x ^ (x >> 16)
    return x < keep_threshold(dropout_p)


def _keep_mask(seed, dropout_p, b, h, sq, sk, q_offsets, device,
               k_offsets=None, bh_offset: int = 0, head_offset: int = 0,
               global_heads: Optional[int] = None):
    """Keep mask (b, h, sq, sk) at absolute positions: bh = (bh_offset +
    b) * global_heads + head_offset + h (global_heads h by default: the
    call's heads are heads [head_offset, head_offset + h) of global_heads),
    query row i at q_offsets[b] + i, key column j at k_offsets[b] + j."""
    hg = h if global_heads is None else int(global_heads)
    bh = ((torch.arange(b, device=device)[:, None] + int(bh_offset)) * hg
          + int(head_offset) + torch.arange(h, device=device)[None, :]
          )[:, :, None, None]
    q_pos = (_per_seq(q_offsets, b, device, 0)[:, None]
             + torch.arange(sq, device=device)[None, :])[:, None, :, None]
    k_pos = (_per_seq(k_offsets, b, device, 0)[:, None]
             + torch.arange(sk, device=device)[None, :])[:, None, None, :]
    return dropout_keep_positions(seed, bh, q_pos, k_pos, dropout_p)


# ------------------------------------------------------------ plain versions

def _valid_mask(b, sq, sk, causal, seq_lengths, q_offsets, device,
                k_offsets=None):
    """(b, 1, sq, sk): key column u below min(seq_lengths[b], sk) and, if
    causal, at most q_offsets[b] - k_offsets[b] + i for query row i (the
    relative offset, which may be negative)."""
    lens = _per_seq(seq_lengths, b, device, sk)
    k_pos = torch.arange(sk, device=device)
    mask = (k_pos[None, :] < torch.clamp(lens, max=sk)[:, None])[:, None, None, :]
    if causal:
        rel = (_per_seq(q_offsets, b, device, 0)
               - _per_seq(k_offsets, b, device, 0))
        q_pos = rel[:, None] + torch.arange(sq, device=device)[None, :]  # (b, sq)
        mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])[:, None]
    return mask


def _scores(q, k, scale, bias=None):
    """The scaled scores (b, h, sq, sk) in f32 from the product in the
    working dtype, plus the f32 bias (broadcast) where one is given."""
    s = torch.einsum("bthd,bshd->bhts", q, k.to(q.dtype)).float() * scale
    return s if bias is None else s + bias.float()


def _attend_ref(q, k, v, mask, scale, keep=None, dropout_p: float = 0.0,
                bias=None):
    """Softmax attention under a validity mask that broadcasts to (b, h, sq,
    sk): the two products in the working dtype (bf16 stays bf16), scores
    (with the bias, before the mask) and softmax in f32, zero output and an
    LSE of ``NEG_INF`` for fully masked rows; ``keep`` drops un-normalised
    probabilities after the sum. -> (out (b, sq, h, d), lse (b, h, sq)
    f32)."""
    s = torch.where(mask, _scores(q, k, scale, bias), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    if keep is not None:
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_p)), 0.0)
    o = torch.einsum("bhts,bshd->bthd", p.to(q.dtype), v.to(q.dtype)).float()
    out = (o / l_safe.permute(0, 2, 1, 3)).to(q.dtype)
    return out, (m + torch.log(l_safe))[..., 0]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        softmax_scale: Optional[float] = None,
                        seq_lengths=None, q_offsets=None,
                        dropout_p: float = 0.0, seed=(0, 0),
                        return_lse: bool = False, k_offsets=None,
                        bh_offset: int = 0, attn_bias=None,
                        head_offset: int = 0, global_heads=None):
    """Plain version of K3: the two products in the working dtype (bf16
    stays bf16), scores and softmax in f32, with the kernel's masks, its
    dropout mask, its zero output for fully masked rows and the additive
    score bias ``attn_bias`` (broadcasting to (b, h, sq, sk))."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    mask = _valid_mask(b, sq, sk, causal, seq_lengths, q_offsets, dev,
                       k_offsets)
    keep = (_keep_mask(seed, dropout_p, b, h, sq, sk, q_offsets, dev,
                       k_offsets, bh_offset, head_offset, global_heads)
            if dropout_p > 0.0 else None)
    out, lse = _attend_ref(q, k, v, mask, scale, keep, dropout_p,
                           _bias4(attn_bias))
    return (out, lse) if return_lse else out


def _attend_bwd_ref(q, k, v, out, lse, dout, mask, scale, keep=None,
                    dropout_p: float = 0.0, bias=None):
    """Gradients of :func:`_attend_ref` from its LSE: p = exp(s - lse) under
    the mask, delta = rowsum(dO * O), ds = p * (dp - delta); the products in
    the working dtype, the rest in f32. -> (dq, dk, dv) in the input
    dtypes, and with a bias also dbias = ds (b, h, sq, sk) f32."""
    cdt = q.dtype
    dout = dout.to(cdt)
    s = _scores(q, k, scale, bias)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bthd,bshd->bhts", dout, v).float()
    if keep is not None:
        inv = 1.0 / (1.0 - dropout_p)
        p_v = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    else:
        p_v = p
    delta = (out.float() * dout.float()).sum(-1).permute(0, 2, 1)[..., None]
    ds32 = p * (dp - delta)
    ds = ds32.to(cdt)
    dv = torch.einsum("bhts,bthd->bshd", p_v.to(cdt), dout).float()
    dq = torch.einsum("bhts,bshd->bthd", ds, k).float() * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, q).float() * scale
    grads = dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    return grads if bias is None else (*grads, ds32)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                            softmax_scale: Optional[float] = None,
                            dropout_p: float = 0.0, seed=(0, 0),
                            q_offsets=None, k_offsets=None,
                            bh_offset: int = 0, attn_bias=None,
                            head_offset: int = 0, global_heads=None):
    """Plain version of K5 (JAX ``_flash_bwd_scratch_kernel`` :681, with a
    bias the split form :460-558): p is recomputed as exp(s - lse) with the
    forward's masks, keep mask and bias, delta = rowsum(dO * O), ds = p *
    (dp - delta); the products in the working dtype, the rest in f32. Any
    sq and sk; the offsets as :func:`flash_attention_ref`'s (given a longer
    attention's global out and lse, the gradients are one chunk pair's
    share). Returns (dq, dk, dv) in the input dtypes, and with a bias also
    dbias (b, h, sq, sk) f32, not yet summed over broadcast dims."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    mask = _valid_mask(b, sq, sk, causal, None, q_offsets, q.device,
                       k_offsets)
    keep = (_keep_mask(seed, dropout_p, b, h, sq, sk, q_offsets, q.device,
                       k_offsets, bh_offset, head_offset, global_heads)
            if dropout_p > 0.0 else None)
    return _attend_bwd_ref(q, k, v, out, lse, dout, mask, scale, keep,
                           dropout_p, _bias4(attn_bias))


def _bias4(bias):
    """A (sq, sk) bias as (1, 1, sq, sk); a 4-D one (or None) as it is."""
    return bias[None, None] if bias is not None and bias.dim() == 2 else bias


def reduce_dbias(dbias: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The full (b, h, sq, sk) f32 ``dbias`` summed back over the dims the
    bias broadcast (b or h of 1, or a 2-D bias) and cast to its dtype
    (JAX ``_flash_bwd_rule`` :1021-1031)."""
    b, h = dbias.shape[:2]
    shape = _bias4(bias).shape
    if shape[0] == 1 and b > 1:
        dbias = dbias.sum(0, keepdim=True)
    if shape[1] == 1 and h > 1:
        dbias = dbias.sum(1, keepdim=True)
    return dbias.reshape(bias.shape).to(bias.dtype)


# ------------------------------------------------------------ kernels

HEAD_DIMS = (64, 80, 96, 128)     # the kernels' head-dim instances


def head_dim_instance(d: int) -> int:
    """The kernels' head dim for head dim d: the least of
    :data:`HEAD_DIMS` at or above it (d itself for the repo's
    configurations; the wrapper pads the rest with zero columns). Raises
    past 128."""
    for inst in HEAD_DIMS:
        if d <= inst:
            return inst
    raise ValueError(f"flash attention kernels take head dims up to "
                     f"{HEAD_DIMS[-1]}, got {d} (wider heads: ROADMAP Queue 2 "
                     f"item 2)")


def pad_heads(inst: int, *xs: torch.Tensor):
    """Each x (..., d) zero-padded to (..., inst) (x itself at d == inst)."""
    return tuple(x if x.shape[-1] == inst
                 else torch.nn.functional.pad(x, (0, inst - x.shape[-1]))
                 for x in xs)


def cut_heads(d: int, *xs: torch.Tensor):
    """Each x (..., inst) cut back to its first d columns, contiguous (x
    itself at d == inst)."""
    return tuple(x if x.shape[-1] == d else x[..., :d].contiguous() for x in xs)


def _check_qkv(q, k, v, dtypes) -> int:
    """Validate the operands of a kernel call; -> the head dim's instance."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    _build.check_cuda_tensor("q", q, dtypes, 4)
    _build.check_cuda_tensor("k", k, (q.dtype,), 4)
    _build.check_cuda_tensor("v", v, (q.dtype,), 4)
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} disagree")
    return head_dim_instance(d)


def _dropout_args(dropout_p, seed):
    if dropout_p > 0.0:
        return (int(seed[0]), int(seed[1]), keep_threshold(dropout_p),
                float(1.0 / (1.0 - dropout_p)), 1)
    return (0, 0, 0, 1.0, 0)


def _per_seq_arg(x, b: int, device) -> Optional[torch.Tensor]:
    """A per-sequence kernel argument as (b,) int32, or None (a NULL
    pointer: the kernel's default), so the common call launches nothing
    but the kernel."""
    return None if x is None else _per_seq(x, b, device, 0).to(
        torch.int32).contiguous()


def _bias_operand(bias, b: int, h: int, sq: int, sk: int, device
                 ) -> Optional[torch.Tensor]:
    """The score bias as the kernels read it: f32 on ``device``, viewed as
    (b|1, h|1, sq, sk) (a 2-D bias as (1, 1, sq, sk)) with a unit key
    stride (a copy only where it has none or is not f32); None for none.
    Raises on a shape that does not broadcast so."""
    if bias is None:
        return None
    t = _bias4(torch.as_tensor(bias, device=device)).to(torch.float32)
    if (t.dim() != 4 or t.shape[0] not in (1, b) or t.shape[1] not in (1, h)
            or tuple(t.shape[2:]) != (sq, sk)):
        raise ValueError(f"attn_bias: shape {tuple(bias.shape)} is not "
                         f"(b|1, h|1, sq, sk) or (sq, sk) for b {b}, h {h}, "
                         f"sq {sq}, sk {sk}")
    return t if t.stride(-1) == 1 else t.contiguous()


def _bias_arg(bias: Optional[torch.Tensor], dbias=None):
    """The C entries' bias descriptor (``csrc/common.cuh`` ScoreBias): NULL
    without a bias, else a host array {address, batch, head and row strides
    (0 where the dim broadcasts), dbias address or 0}. -> (Ptr, the array,
    which the caller keeps until the launch returns)."""
    if bias is None:
        return _build.Ptr(None), None
    st = [0 if n == 1 else s for n, s in zip(bias.shape[:3], bias.stride()[:3])]
    arr = (ctypes.c_longlong * 5)(bias.data_ptr(), *st,
                                  0 if dbias is None else dbias.data_ptr())
    return _build.Ptr(ctypes.addressof(arr)), arr


def _flash_fwd_kernel(q, k, v, *, causal, scale, seq_lengths, q_offsets,
                      dropout_p, seed, k_offsets=None, bh_offset: int = 0,
                      bias=None, head_offset: int = 0, global_heads=None):
    """K3 (``csrc/flash_attention.cu``): bf16 on tensor cores (q, k and v
    rows 16-byte aligned, scale > 0) or on its SIMT loop (f32, unaligned
    bf16); head dims 64, 80, 96 and 128 as they are, any other d <= 128
    padded to the next (:func:`head_dim_instance`); any outer strides; the
    ring forms' k_offsets and bh_offset; a head shard's head_offset and
    global_heads (the dropout stream's); an additive score bias (b|1, h|1,
    sq, sk) or (sq, sk) (:func:`_bias_operand`). Returns (out (b, sq, h, d),
    lse (b, h, sq) f32)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    inst = _check_qkv(q, k, v, (torch.bfloat16, torch.float32))
    q, k, v = pad_heads(inst, q, k, v)
    lens = _per_seq_arg(seq_lengths, b, q.device)
    offs = _per_seq_arg(q_offsets, b, q.device)
    koffs = _per_seq_arg(k_offsets, b, q.device)
    bias = _bias_operand(bias, b, h, sq, sk, q.device)
    bias_ptr, _keep = _bias_arg(bias)
    out = torch.empty((b, sq, h, inst), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    P = _build.Ptr.of
    _build.launch(
        _K3, "flash_attention_launch", P(q), P(k), P(v), P(out), P(lse),
        P(lens), P(offs), P(koffs), bias_ptr, int(bh_offset), int(head_offset),
        h if global_heads is None else int(global_heads), b, h, sq, sk,
        *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], float(scale), int(causal),
        *_dropout_args(dropout_p, seed), inst, _build.DTYPE_CODE[q.dtype])
    return cut_heads(d, out)[0], lse


def _k5_key_tile(s: int, d: int = 64, bias: bool = False) -> int:
    """Keys a CTA of K5's bf16 kernel takes at head dim d (an instance):
    128 (8 warps, half the dq atomics a query row receives) up to s 1024,
    64 (4 warps, two CTAs an SM) past it; on the H100 each was the faster
    at 512 and at 8192 (``bench_flash_bwd.py --key-tiles 64,128``). Past
    d 64 always 128: K and V stay in shared memory there, and a 64-key CTA
    holds as few warps an SM as a 128-key one (one CTA of 4 at d 128).
    With a score bias always 128: its instances are built at that tile
    only."""
    return 128 if s <= 1024 or d > 64 or bias else 64


def _flash_bwd_kernel(q, k, v, out, lse, dout, *, causal, softmax_scale,
                      dropout_p, seed, q_offsets=None, k_offsets=None,
                      bh_offset: int = 0, attn_bias=None,
                      bias_grad: bool = True, head_offset: int = 0,
                      global_heads=None):
    """K5 (``csrc/flash_attention_bwd.cu``): bf16 on tensor cores (rows
    16-byte aligned, else copied contiguous first; dq summed in an f32
    workspace, so its last bits vary between runs) or f32 SIMT; head dims
    as K3's (any other d <= 128 padded, the gradients cut back); any sq and
    sk; the ring forms' q_offsets, k_offsets and bh_offset; a head shard's
    head_offset and global_heads; no lengths.
    -> (dq, dk, dv), contiguous; with ``attn_bias`` also dbias (b, h, sq,
    sk) f32, the pairs' dS (zeros where no pair was visited), or None when
    ``bias_grad`` is False."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    inst = _check_qkv(q, k, v, (torch.bfloat16, torch.float32))
    qoffs = _per_seq_arg(q_offsets, b, q.device)
    koffs = _per_seq_arg(k_offsets, b, q.device)
    bias = _bias_operand(attn_bias, b, h, sq, sk, q.device)
    dbias = (torch.zeros((b, h, sq, sk), dtype=torch.float32, device=q.device)
             if bias is not None and bias_grad else None)
    bias_ptr, _keep = _bias_arg(bias, dbias)
    q, k, v, out, dout = (_build.kernel_operand(t) for t in pad_heads(
        inst, q, k, v, out, dout.to(q.dtype)))
    for name, t in (("out", out), ("dout", dout)):
        _build.check_cuda_tensor(name, t, (q.dtype,), 4)
        if t.shape != q.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != q's")
    _build.check_cuda_tensor("lse", lse, (torch.float32,), 3)
    if lse.shape != (b, h, sq):
        raise ValueError(f"lse: shape {tuple(lse.shape)} != {(b, h, sq)}")
    lse = lse.contiguous()
    dq = torch.empty((b, sq, h, inst), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, inst), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, h, inst), dtype=v.dtype, device=q.device)
    # bf16: the f32 dq accumulator, then the LSE and delta tables padded to
    # whole 64-query tiles; f32: delta
    ws_len = (b * sq * h * inst + 2 * b * h * _round_up(sq, 64)
              if q.dtype == torch.bfloat16 else b * h * sq)
    ws = torch.empty(ws_len, dtype=torch.float32, device=q.device)
    P = _build.Ptr.of
    strides = [s for t in (q, k, v, out, dout) for s in t.stride()[:3]]
    _build.launch(
        _K5, "flash_attention_bwd_launch", P(q), P(k), P(v), P(out),
        P(dout), P(lse), P(ws), P(dq), P(dk), P(dv), P(qoffs), P(koffs),
        bias_ptr, int(bh_offset), int(head_offset),
        h if global_heads is None else int(global_heads), b, h, sq, sk, *strides,
        float(softmax_scale), int(causal), *_dropout_args(dropout_p, seed),
        _k5_key_tile(max(sq, sk), inst, bias is not None), inst,
        _build.DTYPE_CODE[q.dtype])
    grads = cut_heads(d, dq, dk, dv)
    return grads if bias is None else (*grads, dbias)


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        softmax_scale: Optional[float] = None,
                        dropout_p: float = 0.0, seed=(0, 0),
                        q_offsets=None, k_offsets=None, bh_offset: int = 0,
                        attn_bias=None, head_offset: int = 0,
                        global_heads=None):
    """Gradients (dq, dk, dv) of the flash forward, and with ``attn_bias``
    also dbias (b, h, sq, sk) f32 (not summed over broadcast dims: see
    :func:`reduce_dbias`). CPU tensors, and every call inside
    ``_build.plain_path()``, take :func:`flash_attention_bwd_ref`;
    otherwise a CUDA tensor launches K5 (bf16 or f32, d <= 128, any sq and
    sk, the ring forms' offsets, a score bias) or raises."""
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    fn = (_flash_bwd_kernel if q.is_cuda and _build.kernels_enabled()
          else flash_attention_bwd_ref)
    return fn(q, k, v, out, lse, dout, causal=causal, softmax_scale=scale,
              dropout_p=dropout_p, seed=seed, q_offsets=q_offsets,
              k_offsets=k_offsets, bh_offset=bh_offset, attn_bias=attn_bias,
              head_offset=head_offset, global_heads=global_heads)


class _FlashAttention(torch.autograd.Function):
    """K3 forward, K5 backward (JAX ``_flash_attention_bhsd``'s custom_vjp,
    :1009-1036): saves (q, k, v, out, lse, bias) and the dropout seed,
    never the mask. The path (kernel or plain) is decided once, at the
    forward: the backward of a CUDA tensor runs on autograd's device
    thread, which does not see the caller's ``plain_path()``. The bias's
    gradient is summed over its broadcast dims (:func:`reduce_dbias`); K5
    writes none when the bias needs none."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale, dropout_p, seed,
                use_kernel, shard):
        kw = dict(causal=causal, dropout_p=dropout_p, seed=seed, **shard)
        if use_kernel:
            out, lse = _flash_fwd_kernel(q, k, v, scale=scale,
                                         seq_lengths=None, q_offsets=None,
                                         bias=bias, **kw)
        else:
            out, lse = flash_attention_ref(q, k, v, softmax_scale=scale,
                                           return_lse=True, attn_bias=bias,
                                           **kw)
        ctx.save_for_backward(q, k, v, out, lse, bias)
        ctx.kw = dict(kw, softmax_scale=scale)
        ctx.use_kernel = use_kernel
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        *qkv_out_lse, bias = ctx.saved_tensors
        bias_grad = bias is not None and ctx.needs_input_grad[3]
        kw = dict(ctx.kw, attn_bias=bias)
        if ctx.use_kernel:
            grads = _flash_bwd_kernel(*qkv_out_lse, dout, bias_grad=bias_grad,
                                      **kw)
        else:
            grads = flash_attention_bwd_ref(*qkv_out_lse, dout, **kw)
        dbias = reduce_dbias(grads[3], bias) if bias_grad else None
        return (*grads[:3], dbias, None, None, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    softmax_scale: Optional[float] = None,
                    seq_lengths=None,
                    dropout_p: float = 0.0,
                    dropout_rng: Optional[torch.Tensor] = None,
                    q_offsets=None,
                    attn_bias=None,
                    return_lse: bool = False,
                    bh_offset: int = 0,
                    head_offset: int = 0,
                    global_heads: Optional[int] = None):
    """q (b, sq, h, d); k, v (b, sk, h, d) -> (b, sq, h, d) in q's dtype
    [, lse (b, h, sq) f32]. CPU tensors, and every call inside
    ``_build.plain_path()``, take :func:`flash_attention_ref`; otherwise a
    CUDA tensor launches K3 (``csrc/flash_attention.cu``: bf16 or f32,
    d <= 128, any outer strides) or raises. Differentiable in q, k, v and
    ``attn_bias`` when neither ``seq_lengths`` nor ``q_offsets`` is given
    (the backward is K5, bf16 or f32 as the forward).
    attn_bias: an additive score bias (b|1, h|1, sq, sk) or (sq, sk), in
    f32 in the kernels, on every route (JAX :1039).
    dropout_rng: a key of ``utils.prng`` (required when dropout_p > 0).
    The ragged/offset entry (``seq_lengths`` or ``q_offsets``) is forward
    only on the card, as JAX's: it raises when a gradient would be
    recorded; its plain version (CPU tensors, ``plain_path()``) is eager
    PyTorch and differentiable.
    bh_offset, head_offset, global_heads: a data and head shard of a larger
    call (tensor and data parallelism): batch row 0 is row bh_offset of the
    unsharded batch and the h heads are heads [head_offset, head_offset +
    h) of global_heads (h by default), so the dropout mask is the slice of
    the unsharded call's."""
    seed = (0, 0)
    if dropout_p > 0.0:
        if dropout_rng is None:
            raise ValueError("dropout_p > 0 requires dropout_rng")
        seed = prng.seed_words(dropout_rng)
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    use_kernel = q.is_cuda and _build.kernels_enabled()
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, attn_bias))
    ragged = seq_lengths is not None or q_offsets is not None
    shard = dict(bh_offset=int(bh_offset), head_offset=int(head_offset),
                 global_heads=None if global_heads is None else int(global_heads))
    if needs_grad and not ragged:
        out, lse = _FlashAttention.apply(q, k, v, attn_bias, causal,
                                         float(scale), float(dropout_p), seed,
                                         use_kernel, shard)
        return (out, lse) if return_lse else out
    if needs_grad and use_kernel:
        raise RuntimeError(
            "flash_attention: with seq_lengths or q_offsets the kernel route "
            "is forward only (as JAX's), but an operand requires grad; take "
            "the gradient through the plain version (inside "
            "ops._build.plain_path()) or call under torch.no_grad()")
    # no graph to record (or the plain ragged entry, which autograd follows
    # through its eager ops): the forward alone, without the autograd
    # Function's overhead
    kw = dict(causal=causal, seq_lengths=seq_lengths, q_offsets=q_offsets,
              dropout_p=dropout_p, seed=seed, **shard)
    if use_kernel:
        out, lse = _flash_fwd_kernel(q, k, v, scale=scale, bias=attn_bias,
                                     **kw)
    else:
        out, lse = flash_attention_ref(q, k, v, softmax_scale=scale,
                                       return_lse=True, attn_bias=attn_bias,
                                       **kw)
    return (out, lse) if return_lse else out


def _seed_words(seed) -> Tuple[int, int]:
    """JAX's (2,) uint32 seed array, a prng key or an (int, int) pair ->
    the pair of seed words."""
    if seed is None:
        return (0, 0)
    if isinstance(seed, torch.Tensor):
        return prng.seed_words(seed)
    return int(seed[0]), int(seed[1])


def flash_fwd(q, k, v, seq_lengths, scale, causal, block_q: int = 512,
              block_k: int = 512, *, dropout_p: float = 0.0, seed=None,
              q_offsets=None, bias=None, k_offsets=None, bh_offset=None,
              head_offset: int = 0, global_heads=None):
    """JAX's ``_flash_fwd`` (:298) at its signature and layout: q (b, h, sq,
    d), k and v (b, h, sk, d) -> (out (b, h, sq, d), lse (b, h, sq) f32).
    q_offsets, k_offsets: (b,) or scalar absolute positions of query row 0
    and key column 0 (causality uses their difference, the dropout hash the
    absolute ones); bh_offset: the global index of batch row 0; seed: the
    dropout seed words; bias: an additive score bias (b|1, h|1, sq, sk) or
    (sq, sk); head_offset, global_heads: a head shard's place among the
    unsharded call's heads (the dropout stream). The ring's forward building block: K3 on a CUDA tensor (the
    (b, s, h, d) views of the operands, no copy), else its plain version.
    block_q / block_k: the TPU's tiling, not used."""
    del block_q, block_k
    kw = dict(causal=causal, seq_lengths=seq_lengths, q_offsets=q_offsets,
              k_offsets=k_offsets, bh_offset=int(bh_offset or 0),
              dropout_p=dropout_p, seed=_seed_words(seed),
              head_offset=int(head_offset), global_heads=global_heads)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if q.is_cuda and _build.kernels_enabled():
        out, lse = _flash_fwd_kernel(qt, kt, vt, scale=float(scale),
                                     bias=bias, **kw)
    else:
        out, lse = flash_attention_ref(qt, kt, vt, softmax_scale=float(scale),
                                       return_lse=True, attn_bias=bias, **kw)
    return out.transpose(1, 2), lse


def flash_bwd(q, k, v, out, lse, g, seed, scale, causal, block_q: int = 512,
              block_k: int = 512, dropout_p: float = 0.0, bias=None,
              q_offsets=None, k_offsets=None, bh_offset=None,
              head_offset: int = 0, global_heads=None):
    """JAX's ``_flash_bwd`` (:794) at its signature and layout: q, out, g
    (b, h, sq, d), k, v (b, h, sk, d), lse (b, h, sq) -> (dq, dk, dv,
    dbias) in the (b, h, s, d) layout; dbias is None without a bias, else
    (b, h, sq, sk) f32, not summed over the bias's broadcast dims (as
    JAX's). Given a longer attention's GLOBAL out and lse and the chunk
    pair's offsets, the gradients are that pair's exact share (the ring's
    backward building block). K5 on a CUDA tensor, else its plain
    version."""
    del block_q, block_k
    kw = dict(causal=causal, softmax_scale=float(scale), dropout_p=dropout_p,
              seed=_seed_words(seed), q_offsets=q_offsets,
              k_offsets=k_offsets, bh_offset=int(bh_offset or 0),
              attn_bias=bias, head_offset=int(head_offset),
              global_heads=global_heads)
    args = [x.transpose(1, 2) for x in (q, k, v, out)] + [lse, g.transpose(1, 2)]
    fn = (_flash_bwd_kernel if q.is_cuda and _build.kernels_enabled()
          else flash_attention_bwd_ref)
    dq, dk, dv, *dbias = fn(*args, **kw)
    return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
            dbias[0] if dbias else None)


def flash_attention_qkv_packed(qkv: torch.Tensor, *, causal: bool = True,
                               softmax_scale: Optional[float] = None,
                               dropout_p: float = 0.0,
                               dropout_rng: Optional[torch.Tensor] = None,
                               block_q: int = 512, block_k: int = 512):
    """Fused-QKV self-attention (JAX :1497): qkv (b, s, 3, h, d) -> (b, s,
    h, d), differentiable in qkv. K3 and K5 read q, k and v as strided views
    of the packed tensor, so nothing is copied. ``block_q``/``block_k`` are
    the TPU's tiling: accepted, not used."""
    del block_q, block_k
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (b, s, 3, h, d), got {tuple(qkv.shape)}")
    return flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           causal=causal, softmax_scale=softmax_scale,
                           dropout_p=dropout_p, dropout_rng=dropout_rng)


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             softmax_scale: Optional[float] = None,
                             seq_lengths=None, block_q: int = 256,
                             block_k: int = 512):
    """The forward with its log-sum-exp (JAX :1538): (out (b, sq, h, d),
    lse (b, h, sq) f32), through K3 on the card. ``block_q``/``block_k``:
    the TPU's tiling, not used."""
    del block_q, block_k
    return flash_attention(q, k, v, causal=causal, softmax_scale=softmax_scale,
                           seq_lengths=seq_lengths, return_lse=True)


# ------------------------------------------------------------ block-sparse (K9)

def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def blocksparse_active(blockmask: torch.Tensor, causal: bool, block_q: int,
                       block_k: int) -> torch.Tensor:
    """The active tiles (n_qb, n_kb) bool, with the causal pre-filter of JAX
    ``_bs_active`` (:1175): a tile whose first key lies past the last row of
    its query block is dropped. The per-element causal mask still applies
    inside the tiles that stay."""
    active = blockmask.to(torch.bool)
    if causal:
        n_qb, n_kb = active.shape
        dev = active.device
        reach = (torch.arange(n_qb, device=dev)[:, None] + 1) * block_q
        active = active & (torch.arange(n_kb, device=dev)[None, :] * block_k
                           < reach)
    return active


def _bs_mask(active, b, sq, sk, block_q, block_k, causal, seq_lengths):
    """The element mask (b, 1, sq, sk) of the block-sparse op: an active
    tile, a key below min(seq_len, sk), and, if causal, key <= query."""
    dev = active.device
    qi = torch.arange(sq, device=dev)
    kj = torch.arange(sk, device=dev)
    mask = active[qi // block_q][:, kj // block_k]
    if causal:
        mask = mask & (kj[None, :] <= qi[:, None])
    lens = _per_seq(seq_lengths, b, dev, sk)
    keys = kj[None, :] < torch.clamp(lens, max=sk)[:, None]        # (b, sk)
    return (mask[None] & keys[:, None, :])[:, None]


def blocksparse_attention_ref(q, k, v, active, *, causal: bool, block_q: int,
                              block_k: int, seq_lengths=None):
    """Plain version of K9's forward: the dense masked softmax over q, which
    the caller has already scaled (JAX :1439). -> (out (b, sq, h, d),
    lse (b, h, sq) f32); a row with no valid key gives 0 and ``NEG_INF``."""
    b, sq = q.shape[:2]
    mask = _bs_mask(active, b, sq, k.shape[1], block_q, block_k, causal,
                    seq_lengths)
    return _attend_ref(q, k, v, mask, 1.0)


def blocksparse_attention_bwd_ref(q, k, v, out, lse, dout, active, *,
                                  causal: bool, block_q: int, block_k: int):
    """Plain version of K9's backward (both kernels): the dense recomputed
    backward under the forward's mask. -> (dq, dk, dv)."""
    b, sq = q.shape[:2]
    mask = _bs_mask(active, b, sq, k.shape[1], block_q, block_k, causal, None)
    return _attend_bwd_ref(q, k, v, out, lse, dout, mask, 1.0)


_BS_TILE = 64      # the rows of a K9 tile: its blocks split into 64s


def _k9_rows(sq: int, block_q: int, d: int = 64) -> int:
    """Query rows a CTA of K9's bf16 forward takes at head dim d (an
    instance): K3's rule (``csrc/flash_attention.cuh`` ``k3_rows``: 32 at
    sq <= 32, 64 up to sq 1024 and at every sq past d 64, 128 past it at
    d 64), held to a divisor of block_q."""
    rows = 32 if sq <= 32 else 64 if sq <= 1024 or d > 64 else 128
    return rows if block_q % rows == 0 else _BS_TILE


def _k9_key_tile(sq: int, sk: int, block_k: int, d: int = 64) -> int:
    """Keys a CTA of K9's bf16 backward takes at head dim d: K5's rule
    (:func:`_k5_key_tile` at the longer side), held to a divisor of
    block_k."""
    tile = _k5_key_tile(max(sq, sk), d)
    return tile if block_k % tile == 0 else _BS_TILE


class BsTables(NamedTuple):
    """What K9's kernels walk, built once a call on the operands' device
    (``csrc/blocksparse_tables.cuh``, launched by the forward's C entry;
    :func:`_bs_tables` is its plain version). ``row_idx[i, :row_cnt[i]]``:
    query block i's active key blocks in order (JAX ``_bs_fwd``'s ``tbl`` /
    ``cnt``, :1197-1202), its inactive ones after them;
    ``col_idx[j, :col_cnt[j]]``: key block j's active query blocks, the
    backward's columns. ``fwd_order``: the forward's query tiles of
    ``rows`` rows, most key tiles first; ``bwd_order``: the backward's key
    tiles of ``key_tile`` keys, most query tiles first. All int32."""
    row_idx: torch.Tensor
    row_cnt: torch.Tensor
    col_idx: torch.Tensor
    col_cnt: torch.Tensor
    fwd_order: torch.Tensor
    bwd_order: torch.Tensor
    rows: int
    key_tile: int


def _active_lists(active: torch.Tensor):
    """Each row's active columns in order, first, and their count."""
    idx = torch.argsort((~active).to(torch.int32), dim=1, stable=True)
    return idx.to(torch.int32).contiguous(), active.sum(1, dtype=torch.int32)


def _check_blocks(block_q: int, block_k: int) -> None:
    if block_q % _BS_TILE or block_k % _BS_TILE:
        raise ValueError(f"the block-sparse kernels take block_q and block_k "
                         f"in multiples of {_BS_TILE}, got {block_q} and {block_k}")


def _bs_tables(active: torch.Tensor, sq: int, sk: int, *, causal: bool,
               block_q: int, block_k: int, d: int = 64) -> BsTables:
    """Plain version of the table kernels (:class:`BsTables`) from the
    active tiles (n_qb, n_kb) (causal pre-filter applied), in tensor ops.
    A CTA's work is the 64-row tiles its walk visits: the forward's query
    tile of ``rows`` rows takes the 64-key tiles of its row's active blocks
    below its last visible key (causal: its last row; and sk); the
    backward's key tile takes the 64-query tiles of its column's active
    blocks from its first key on (causal) and below sq. d: the kernels'
    head dim (an instance), which the tiles follow."""
    _check_blocks(block_q, block_k)
    dev, active = active.device, active.to(torch.bool)
    rows, key_tile = _k9_rows(sq, block_q, d), _k9_key_tile(sq, sk, block_k, d)
    row_idx, row_cnt = _active_lists(active)
    col_idx, col_cnt = _active_lists(active.t())
    cdiv = lambda x: (x + _BS_TILE - 1) // _BS_TILE

    q0 = torch.arange(0, sq, rows, device=dev)
    end = torch.clamp(q0 + rows, max=min(sq, sk)) if causal else torch.full_like(q0, sk)
    k_lo = torch.arange(active.shape[1], device=dev) * block_k
    keys = (torch.minimum(end[:, None], k_lo + block_k) - k_lo).clamp(min=0)
    fwd_work = (active[q0 // block_q] * cdiv(keys)).sum(1)

    k0 = torch.arange(0, sk, key_tile, device=dev)
    q_lo = torch.arange(active.shape[0], device=dev) * block_q
    first = torch.maximum(q_lo[None, :], k0[:, None]) if causal else q_lo[None, :]
    queries = (torch.clamp(q_lo + block_q, max=sq)[None, :] - first).clamp(min=0)
    bwd_work = (active.t()[k0 // block_k] * cdiv(queries)).sum(1)

    order = lambda w: torch.argsort(-w, stable=True).to(torch.int32)
    return BsTables(row_idx, row_cnt, col_idx, col_cnt, order(fwd_work),
                    order(bwd_work), rows, key_tile)


def _bs_table_buffers(n_qb: int, n_kb: int, sq: int, sk: int, block_q: int,
                      block_k: int, d: int, device):
    """Room for the table kernels' output at head dim d (an instance), one
    int32 allocation: the :class:`BsTables` views and the kernels' work
    scratch."""
    _check_blocks(block_q, block_k)
    rows, key_tile = _k9_rows(sq, block_q, d), _k9_key_tile(sq, sk, block_k, d)
    n_qt, n_kt = -(-sq // rows), -(-sk // key_tile)
    sizes = (n_qb * n_kb, n_qb, n_kb * n_qb, n_kb, n_qt, n_kt, n_qt + n_kt)
    parts = torch.empty(sum(sizes), dtype=torch.int32, device=device).split(sizes)
    tables = BsTables(parts[0].view(n_qb, n_kb), parts[1], parts[2].view(n_kb, n_qb),
                      parts[3], parts[4], parts[5], rows, key_tile)
    return tables, parts[6]


def _bs_fwd_kernel(q, k, v, blockmask, *, causal, block_q, block_k,
                   seq_lengths=None):
    """K9 forward (``csrc/blocksparse_attention.cu``), one C entry: the tile
    tables built from the blockmask (the causal pre-filter applied there),
    then the attention, bf16 on K3's tensor-core body or f32 SIMT; head
    dims as K3's (any other d <= 128 padded, out cut back), pre-scaled q.
    -> (out, lse, tables); (out, lse) as the plain version's, the tables
    for the backward."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    inst = _check_qkv(q, k, v, (torch.bfloat16, torch.float32))
    q, k, v = (_build.kernel_operand(t) for t in pad_heads(inst, q, k, v))
    mask = blockmask.to(torch.int32).contiguous()
    tables, work = _bs_table_buffers(*mask.shape, sq, sk, block_q, block_k, inst, q.device)
    lens = _per_seq_arg(seq_lengths, b, q.device)
    out = torch.empty((b, sq, h, inst), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    P = _build.Ptr.of
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    _build.launch(_K9, "blocksparse_fwd_launch", P(q), P(k), P(v), P(out),
                  P(lse), P(lens), P(mask), *(P(x) for x in tables[:6]), P(work),
                  b, h, sq, sk, *mask.shape, block_q, block_k, tables.rows,
                  tables.key_tile, *strides, 1.0, int(causal), inst,
                  _build.DTYPE_CODE[q.dtype])
    return cut_heads(d, out)[0], lse, tables


def _bs_bwd_kernel(q, k, v, out, lse, dout, tables: BsTables, *, causal,
                   block_q, block_k):
    """K9 backward (``csrc/blocksparse_attention_bwd.cu``), one C entry over
    the tables its forward built: bf16 on K5's single pass (prep, main,
    convert; dq summed in an f32 workspace, so its last bits vary between
    runs) or f32 SIMT; head dims as K3's (any other d <= 128 padded, the
    gradients cut back), any sq and sk. -> (dq, dk, dv), contiguous."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    inst = _check_qkv(q, k, v, (torch.bfloat16, torch.float32))
    q, k, v, out, dout = (_build.kernel_operand(t) for t in pad_heads(
        inst, q, k, v, out, dout.to(q.dtype)))
    for name, x in (("out", out), ("dout", dout)):
        _build.check_cuda_tensor(name, x, (q.dtype,), 4)
        if x.shape != q.shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != q's")
    _build.check_cuda_tensor("lse", lse, (torch.float32,), 3)
    if lse.shape != (b, h, sq):
        raise ValueError(f"lse: shape {tuple(lse.shape)} != {(b, h, sq)}")
    lse = lse.contiguous()
    dq = torch.empty((b, sq, h, inst), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, inst), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, h, inst), dtype=v.dtype, device=q.device)
    # as K5's: bf16 the f32 dq accumulator and the LSE and delta tables
    # padded to whole 64-query tiles; f32 delta
    ws_len = (b * sq * h * inst + 2 * b * h * _round_up(sq, _BS_TILE)
              if q.dtype == torch.bfloat16 else b * h * sq)
    ws = torch.empty(ws_len, dtype=torch.float32, device=q.device)
    P = _build.Ptr.of
    strides = [s for x in (q, k, v, out, dout) for s in x.stride()[:3]]
    _build.launch(_K9_BWD, "blocksparse_bwd_launch", P(q), P(k), P(v),
                  P(out), P(dout), P(lse), P(ws), P(dq), P(dk), P(dv),
                  *(P(x) for x in tables[:4]), P(tables.bwd_order), b, h, sq,
                  sk, *tables.row_idx.shape, block_q, block_k,
                  tables.key_tile, *strides, 1.0, int(causal), inst,
                  _build.DTYPE_CODE[q.dtype])
    return cut_heads(d, dq, dk, dv)


class _BlockSparseAttention(torch.autograd.Function):
    """K9 forward, K9 backward (JAX ``_blocksparse_bhsd``'s custom_vjp,
    :1327-1410) over pre-scaled q: saves (q, k, v, out, lse) and, on the
    kernel path, keeps the tile tables the forward built, so that a
    forward-plus-backward call builds them once; the plain path saves the
    active tiles too. ``active``: the active tiles (the plain path), or the
    blockmask itself (the kernel path, whose table kernels apply the
    causal pre-filter). The path is decided once, at the forward, as in
    :class:`_FlashAttention`."""

    @staticmethod
    def forward(ctx, q, k, v, active, causal, block_q, block_k, use_kernel):
        kw = dict(causal=causal, block_q=block_q, block_k=block_k)
        if use_kernel:
            out, lse, ctx.tables = _bs_fwd_kernel(q, k, v, active, **kw)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out, lse = blocksparse_attention_ref(q, k, v, active, **kw)
            ctx.save_for_backward(q, k, v, out, lse, active)
        ctx.kw = kw
        ctx.use_kernel = use_kernel
        return out

    @staticmethod
    def backward(ctx, dout):
        if ctx.use_kernel:
            q, k, v, out, lse = ctx.saved_tensors
            dq, dk, dv = _bs_bwd_kernel(q, k, v, out, lse, dout, ctx.tables, **ctx.kw)
        else:
            q, k, v, out, lse, active = ctx.saved_tensors
            dq, dk, dv = blocksparse_attention_bwd_ref(q, k, v, out, lse, dout,
                                                       active, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_blocksparse_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, blockmask, *,
                                causal: bool = True,
                                softmax_scale: Optional[float] = None,
                                seq_lengths=None,
                                block_q: int = 256, block_k: int = 256):
    """Block-sparse FlashAttention (JAX :1415). q (b, sq, h, d); k, v
    (b, sk, h, d); blockmask (ceil(sq / block_q), ceil(sk / block_k)), 1
    for the tiles attended. -> (b, sq, h, d) in q's dtype.

    q is scaled and rounded to its dtype first, as in JAX; tiles with 0 in
    the blockmask contribute nothing, a row with no active tile gives 0.
    Without ``seq_lengths`` the op is differentiable in q, k, v (K9's
    backward, one C entry); with it, keys at or past ``seq_lengths[b]`` are
    masked and the op is forward only, as in JAX. CPU tensors, and every
    call inside ``_build.plain_path()``, take the plain versions; otherwise
    a CUDA tensor launches K9 (bf16 or f32, d <= 128, block_q and block_k
    multiples of 64, any number of blocks) or raises."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    # rounded to q's dtype after an f32 product, as JAX's q.astype(f32) *
    # scale -> q.dtype: PyTorch multiplies a bf16 tensor by a scalar in f32
    q = q * scale
    block_q = min(block_q, _round_up(sq, 128))
    block_k = min(block_k, _round_up(sk, 128))
    n_qb, n_kb = -(-sq // block_q), -(-sk // block_k)
    blockmask = torch.as_tensor(blockmask, device=q.device)
    if tuple(blockmask.shape) != (n_qb, n_kb):
        raise ValueError(f"blockmask shape {tuple(blockmask.shape)} != "
                         f"{(n_qb, n_kb)}")
    use_kernel = q.is_cuda and _build.kernels_enabled()
    # the kernels' table pass applies the causal pre-filter itself
    active = (blockmask if use_kernel
              else blocksparse_active(blockmask, causal, block_q, block_k))
    kw = dict(causal=causal, block_q=block_q, block_k=block_k)
    if seq_lengths is None:
        return _BlockSparseAttention.apply(q, k, v, active, causal, block_q,
                                           block_k, use_kernel)
    fn = _bs_fwd_kernel if use_kernel else blocksparse_attention_ref
    return fn(q, k, v, active, seq_lengths=seq_lengths, **kw)[0]
