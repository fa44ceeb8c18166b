"""FlashAttention forward (kernel K3) and backward (kernel K5).

Port of ``backpacks_flash_attn_tpu/ops/flash_attention.py``
(``flash_attention`` :1039 -> ``_flash_fwd`` :298 -> ``_flash_fwd_kernel``
:158, and the ``custom_vjp`` around it, :1009-1036, whose backward is
``_flash_bwd`` :794) for causal masking, per-sequence ``seq_lengths`` and
``q_offsets``, and attention dropout: key column u of sequence b is valid
when ``u < min(seq_lengths[b], sk)`` and, if causal, ``u <= q_offsets[b] +
i`` for query row i. Fully masked rows give 0 and an LSE of ``NEG_INF``.

Dropout keeps a probability where the counter hash of ``(seed, b*H + h,
q_offsets[b] + i, j)`` falls below a threshold (``dropout_keep_positions``,
JAX :120), so the forward, the backward and the plain versions all draw the
same mask without storing it. It is applied to the un-normalised
probabilities after the running max and sum, so the LSE stays the one of
the softmax before dropout (JAX :250-259).

The differentiable entry (no ``seq_lengths``/``q_offsets``, as in JAX)
saves ``(q, k, v, out, lse)`` and the seed; its backward is K5 on the card
and :func:`flash_attention_bwd_ref` on the CPU. The ragged/offset entry is
inference only. An additive score bias (and K5's ``dbias``) waits for
ROADMAP Queue 2 item 3.

Block-sparse attention (kernel K9) is :func:`flash_blocksparse_attention`
(JAX :1415): the same online softmax over only the (block_q, block_k) tiles
a blockmask marks, forward through ``_bs_fwd`` (:1185) and backward through
``_bs_bwd_rule`` (:1362).
"""

from __future__ import annotations

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


def _keep_mask(seed, dropout_p, b, h, sq, sk, q_offsets, device):
    """Keep mask (b, h, sq, sk) at absolute positions: bh = b*H + h, query
    row i at q_offsets[b] + i, key column j at j."""
    bh = (torch.arange(b, device=device)[:, None] * h
          + torch.arange(h, device=device)[None, :])[:, :, None, None]
    q_pos = (_per_seq(q_offsets, b, device, 0)[:, None]
             + torch.arange(sq, device=device)[None, :])[:, None, :, None]
    k_pos = torch.arange(sk, device=device)[None, None, None, :]
    return dropout_keep_positions(seed, bh, q_pos, k_pos, dropout_p)


# ------------------------------------------------------------ plain versions

def _valid_mask(b, sq, sk, causal, seq_lengths, q_offsets, device):
    lens = _per_seq(seq_lengths, b, device, sk)
    k_pos = torch.arange(sk, device=device)
    mask = (k_pos[None, :] < torch.clamp(lens, max=sk)[:, None])[:, None, None, :]
    if causal:
        q_pos = (_per_seq(q_offsets, b, device, 0)[:, None]
                 + torch.arange(sq, device=device)[None, :])          # (b, sq)
        mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])[:, None]
    return mask


def _attend_ref(q, k, v, mask, scale, keep=None, dropout_p: float = 0.0):
    """Softmax attention under a validity mask that broadcasts to (b, h, sq,
    sk): the two products in the working dtype (bf16 stays bf16), scores
    and softmax in f32, zero output and an LSE of ``NEG_INF`` for fully
    masked rows; ``keep`` drops un-normalised probabilities after the sum.
    -> (out (b, sq, h, d), lse (b, h, sq) f32)."""
    s = torch.einsum("bthd,bshd->bhts", q, k.to(q.dtype)).float() * scale
    s = torch.where(mask, s, NEG_INF)
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
                        return_lse: bool = False):
    """Plain version of K3: the two products in the working dtype (bf16
    stays bf16), scores and softmax in f32, with the kernel's masks, its
    dropout mask and its zero output for fully masked rows."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    mask = _valid_mask(b, sq, sk, causal, seq_lengths, q_offsets, dev)
    keep = (_keep_mask(seed, dropout_p, b, h, sq, sk, q_offsets, dev)
            if dropout_p > 0.0 else None)
    out, lse = _attend_ref(q, k, v, mask, scale, keep, dropout_p)
    return (out, lse) if return_lse else out


def _attend_bwd_ref(q, k, v, out, lse, dout, mask, scale, keep=None,
                    dropout_p: float = 0.0):
    """Gradients of :func:`_attend_ref` from its LSE: p = exp(s - lse) under
    the mask, delta = rowsum(dO * O), ds = p * (dp - delta); the products in
    the working dtype, the rest in f32. -> (dq, dk, dv) in the input
    dtypes."""
    cdt = q.dtype
    dout = dout.to(cdt)
    s = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bthd,bshd->bhts", dout, v).float()
    if keep is not None:
        inv = 1.0 / (1.0 - dropout_p)
        p_v = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    else:
        p_v = p
    delta = (out.float() * dout.float()).sum(-1).permute(0, 2, 1)[..., None]
    ds = (p * (dp - delta)).to(cdt)
    dv = torch.einsum("bhts,bthd->bshd", p_v.to(cdt), dout).float()
    dq = torch.einsum("bhts,bshd->bthd", ds, k).float() * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, q).float() * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                            softmax_scale: Optional[float] = None,
                            dropout_p: float = 0.0, seed=(0, 0)):
    """Plain version of K5 (JAX ``_flash_bwd_scratch_kernel`` :681): p is
    recomputed as exp(s - lse) with the forward's masks and keep mask,
    delta = rowsum(dO * O), ds = p * (dp - delta); the products in the
    working dtype, the rest in f32. Returns (dq, dk, dv) in the input
    dtypes."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    mask = _valid_mask(b, sq, sk, causal, None, None, q.device)
    keep = (_keep_mask(seed, dropout_p, b, h, sq, sk, None, q.device)
            if dropout_p > 0.0 else None)
    return _attend_bwd_ref(q, k, v, out, lse, dout, mask, scale, keep,
                           dropout_p)


# ------------------------------------------------------------ kernels

def _check_qkv(q, k, v, dtypes):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    _build.check_cuda_tensor("q", q, dtypes, 4)
    _build.check_cuda_tensor("k", k, (q.dtype,), 4)
    _build.check_cuda_tensor("v", v, (q.dtype,), 4)
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} disagree")
    if d != 64:
        raise ValueError(f"flash attention kernels take head dim 64, got {d} "
                         f"(other head dims: ROADMAP Queue 2)")


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


def _flash_fwd_kernel(q, k, v, *, causal, scale, seq_lengths, q_offsets,
                      dropout_p, seed):
    """K3 (``csrc/flash_attention.cu``): bf16 on tensor cores (q, k and v
    rows 16-byte aligned, scale > 0) or on its SIMT loop (f32, unaligned
    bf16); d = 64, any outer strides. Returns (out (b, sq, h, d), lse
    (b, h, sq) f32)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    _check_qkv(q, k, v, (torch.bfloat16, torch.float32))
    lens = _per_seq_arg(seq_lengths, b, q.device)
    offs = _per_seq_arg(q_offsets, b, q.device)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    P = _build.Ptr.of
    _build.launch(
        _K3, "flash_attention_launch", P(q), P(k), P(v), P(out), P(lse),
        P(lens), P(offs), b, h, sq, sk, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], float(scale), int(causal),
        *_dropout_args(dropout_p, seed), _build.DTYPE_CODE[q.dtype])
    return out, lse


def _k5_key_tile(s: int) -> int:
    """Keys a CTA of K5's bf16 kernel takes: 128 (8 warps, half the dq
    atomics a query row receives) up to s 1024, 64 (4 warps, two CTAs an
    SM) past it; on the H100 each was the faster at 512 and at 8192
    (``bench_flash_bwd.py --key-tiles 64,128``)."""
    return 128 if s <= 1024 else 64


def _flash_bwd_kernel(q, k, v, out, lse, dout, *, causal, softmax_scale,
                      dropout_p, seed):
    """K5 (``csrc/flash_attention_bwd.cu``): bf16 on tensor cores (rows
    16-byte aligned, else copied contiguous first; dq summed in an f32
    workspace, so its last bits vary between runs) or f32 SIMT; d = 64,
    sq == sk, no lengths or offsets. -> (dq, dk, dv), contiguous."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    _check_qkv(q, k, v, (torch.bfloat16, torch.float32))
    if sq != sk:
        raise ValueError(f"flash_attention_bwd kernel takes sq == sk, got "
                         f"{sq} and {sk}")
    q, k, v, out, dout = (_build.kernel_operand(t)
                          for t in (q, k, v, out, dout.to(q.dtype)))
    for name, t in (("out", out), ("dout", dout)):
        _build.check_cuda_tensor(name, t, (q.dtype,), 4)
        if t.shape != q.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != q's")
    _build.check_cuda_tensor("lse", lse, (torch.float32,), 3)
    if lse.shape != (b, h, sq):
        raise ValueError(f"lse: shape {tuple(lse.shape)} != {(b, h, sq)}")
    lse = lse.contiguous()
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=q.device)
    # bf16: the f32 dq accumulator, then the LSE and delta tables padded to
    # whole 64-query tiles; f32: delta
    ws_len = (b * sq * h * d + 2 * b * h * _round_up(sq, 64)
              if q.dtype == torch.bfloat16 else b * h * sq)
    ws = torch.empty(ws_len, dtype=torch.float32, device=q.device)
    P = _build.Ptr.of
    strides = [s for t in (q, k, v, out, dout) for s in t.stride()[:3]]
    _build.launch(
        _K5, "flash_attention_bwd_launch", P(q), P(k), P(v), P(out),
        P(dout), P(lse), P(ws), P(dq), P(dk), P(dv), b, h, sq, *strides,
        float(softmax_scale), int(causal), *_dropout_args(dropout_p, seed),
        _k5_key_tile(sq), _build.DTYPE_CODE[q.dtype])
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        softmax_scale: Optional[float] = None,
                        dropout_p: float = 0.0, seed=(0, 0)):
    """Gradients (dq, dk, dv) of the flash forward. CPU tensors, and every
    call inside ``_build.plain_path()``, take
    :func:`flash_attention_bwd_ref`; otherwise a CUDA tensor launches K5
    (bf16 or f32, d = 64, sq == sk) or raises."""
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    fn = (_flash_bwd_kernel if q.is_cuda and _build.kernels_enabled()
          else flash_attention_bwd_ref)
    return fn(q, k, v, out, lse, dout, causal=causal, softmax_scale=scale,
              dropout_p=dropout_p, seed=seed)


class _FlashAttention(torch.autograd.Function):
    """K3 forward, K5 backward (JAX ``_flash_attention_bhsd``'s custom_vjp,
    :1009-1036): saves (q, k, v, out, lse) and the dropout seed, never the
    mask. The path (kernel or plain) is decided once, at the forward: the
    backward of a CUDA tensor runs on autograd's device thread, which does
    not see the caller's ``plain_path()``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, dropout_p, seed, use_kernel):
        kw = dict(causal=causal, dropout_p=dropout_p, seed=seed)
        if use_kernel:
            out, lse = _flash_fwd_kernel(q, k, v, scale=scale,
                                         seq_lengths=None, q_offsets=None,
                                         **kw)
        else:
            out, lse = flash_attention_ref(q, k, v, softmax_scale=scale,
                                           return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(kw, softmax_scale=scale)
        ctx.use_kernel = use_kernel
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        fn = _flash_bwd_kernel if ctx.use_kernel else flash_attention_bwd_ref
        dq, dk, dv = fn(*ctx.saved_tensors, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    softmax_scale: Optional[float] = None,
                    seq_lengths=None,
                    dropout_p: float = 0.0,
                    dropout_rng: Optional[torch.Tensor] = None,
                    q_offsets=None,
                    attn_bias=None,
                    return_lse: bool = False):
    """q (b, sq, h, d); k, v (b, sk, h, d) -> (b, sq, h, d) in q's dtype
    [, lse (b, h, sq) f32]. CPU tensors, and every call inside
    ``_build.plain_path()``, take :func:`flash_attention_ref`; otherwise a
    CUDA tensor launches K3 (``csrc/flash_attention.cu``: bf16 or f32,
    d = 64, any outer strides) or raises. Differentiable in q, k, v when
    neither ``seq_lengths`` nor ``q_offsets`` is given (the backward is K5,
    bf16 or f32 as the forward).
    dropout_rng: a key of ``utils.prng`` (required when dropout_p > 0)."""
    if attn_bias is not None:
        raise NotImplementedError("attn_bias (a score bias in K3, dbias in "
                                  "K5) comes with ROADMAP Queue 2 item 3")
    seed = (0, 0)
    if dropout_p > 0.0:
        if dropout_rng is None:
            raise ValueError("dropout_p > 0 requires dropout_rng")
        seed = prng.seed_words(dropout_rng)
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    use_kernel = q.is_cuda and _build.kernels_enabled()
    needs_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if needs_grad and seq_lengths is None and q_offsets is None:
        out, lse = _FlashAttention.apply(q, k, v, causal, float(scale),
                                         float(dropout_p), seed, use_kernel)
        return (out, lse) if return_lse else out
    # no graph to record (or the inference-only ragged entry): the forward
    # alone, without the autograd Function's overhead
    kw = dict(causal=causal, seq_lengths=seq_lengths, q_offsets=q_offsets,
              dropout_p=dropout_p, seed=seed)
    if use_kernel:
        out, lse = _flash_fwd_kernel(q, k, v, scale=scale, **kw)
    else:
        out, lse = flash_attention_ref(q, k, v, softmax_scale=scale,
                                       return_lse=True, **kw)
    return (out, lse) if return_lse else out


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


def _k9_rows(sq: int, block_q: int) -> int:
    """Query rows a CTA of K9's bf16 forward takes: K3's rule
    (``csrc/flash_attention.cuh`` ``k3_rows``: 32 at sq <= 32, 64 up to sq
    1024, 128 past it), held to a divisor of block_q."""
    rows = 32 if sq <= 32 else 64 if sq <= 1024 else 128
    return rows if block_q % rows == 0 else _BS_TILE


def _k9_key_tile(sq: int, sk: int, block_k: int) -> int:
    """Keys a CTA of K9's bf16 backward takes: K5's rule
    (:func:`_k5_key_tile` at the longer side), held to a divisor of
    block_k."""
    tile = _k5_key_tile(max(sq, sk))
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
               block_q: int, block_k: int) -> BsTables:
    """Plain version of the table kernels (:class:`BsTables`) from the
    active tiles (n_qb, n_kb) (causal pre-filter applied), in tensor ops.
    A CTA's work is the 64-row tiles its walk visits: the forward's query
    tile of ``rows`` rows takes the 64-key tiles of its row's active blocks
    below its last visible key (causal: its last row; and sk); the
    backward's key tile takes the 64-query tiles of its column's active
    blocks from its first key on (causal) and below sq."""
    _check_blocks(block_q, block_k)
    dev, active = active.device, active.to(torch.bool)
    rows, key_tile = _k9_rows(sq, block_q), _k9_key_tile(sq, sk, block_k)
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
                      block_k: int, device):
    """Room for the table kernels' output, one int32 allocation: the
    :class:`BsTables` views and the kernels' work scratch."""
    _check_blocks(block_q, block_k)
    rows, key_tile = _k9_rows(sq, block_q), _k9_key_tile(sq, sk, block_k)
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
    then the attention, bf16 on K3's tensor-core body or f32 SIMT; d = 64,
    pre-scaled q. -> (out, lse, tables); (out, lse) as the plain version's,
    the tables for the backward."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    _check_qkv(q, k, v, (torch.bfloat16, torch.float32))
    q, k, v = (_build.kernel_operand(t) for t in (q, k, v))
    mask = blockmask.to(torch.int32).contiguous()
    tables, work = _bs_table_buffers(*mask.shape, sq, sk, block_q, block_k, q.device)
    lens = _per_seq_arg(seq_lengths, b, q.device)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    P = _build.Ptr.of
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    _build.launch(_K9, "blocksparse_fwd_launch", P(q), P(k), P(v), P(out),
                  P(lse), P(lens), P(mask), *(P(x) for x in tables[:6]), P(work),
                  b, h, sq, sk, *mask.shape, block_q, block_k, tables.rows,
                  tables.key_tile, *strides, 1.0, int(causal),
                  _build.DTYPE_CODE[q.dtype])
    return out, lse, tables


def _bs_bwd_kernel(q, k, v, out, lse, dout, tables: BsTables, *, causal,
                   block_q, block_k):
    """K9 backward (``csrc/blocksparse_attention_bwd.cu``), one C entry over
    the tables its forward built: bf16 on K5's single pass (prep, main,
    convert; dq summed in an f32 workspace, so its last bits vary between
    runs) or f32 SIMT; d = 64, any sq and sk. -> (dq, dk, dv),
    contiguous."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    _check_qkv(q, k, v, (torch.bfloat16, torch.float32))
    q, k, v, out, dout = (_build.kernel_operand(t)
                          for t in (q, k, v, out, dout.to(q.dtype)))
    for name, x in (("out", out), ("dout", dout)):
        _build.check_cuda_tensor(name, x, (q.dtype,), 4)
        if x.shape != q.shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != q's")
    _build.check_cuda_tensor("lse", lse, (torch.float32,), 3)
    if lse.shape != (b, h, sq):
        raise ValueError(f"lse: shape {tuple(lse.shape)} != {(b, h, sq)}")
    lse = lse.contiguous()
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=q.device)
    # as K5's: bf16 the f32 dq accumulator and the LSE and delta tables
    # padded to whole 64-query tiles; f32 delta
    ws_len = (b * sq * h * d + 2 * b * h * _round_up(sq, _BS_TILE)
              if q.dtype == torch.bfloat16 else b * h * sq)
    ws = torch.empty(ws_len, dtype=torch.float32, device=q.device)
    P = _build.Ptr.of
    strides = [s for x in (q, k, v, out, dout) for s in x.stride()[:3]]
    _build.launch(_K9_BWD, "blocksparse_bwd_launch", P(q), P(k), P(v),
                  P(out), P(dout), P(lse), P(ws), P(dq), P(dk), P(dv),
                  *(P(x) for x in tables[:4]), P(tables.bwd_order), b, h, sq,
                  sk, *tables.row_idx.shape, block_q, block_k,
                  tables.key_tile, *strides, 1.0, int(causal),
                  _build.DTYPE_CODE[q.dtype])
    return dq, dk, dv


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
    a CUDA tensor launches K9 (bf16 or f32, d = 64, block_q and block_k
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
