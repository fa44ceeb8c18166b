"""Fused Backpack contextualization: forward (kernel K4) and training
backward (kernel K6).

Port of ``backpacks_flash_attn_tpu/ops/backpack_kernels.py``
(``fused_contextualization`` :424, a ``custom_vjp`` :423-452 whose forward
is ``_fused_ctx_infer`` :281 / ``_fused_ctx_fwd_lse`` :309 and whose
backward is ``_fused_ctx_bwd`` :345):

    out[b,t,:] = sum_k causal_softmax_j(scale * q[b,t,k] . k[b,j,k]) @ content[b,j,k,:]

without materializing alpha (b, nv, s, s). The forward also returns the
per-(row, head) LSE, which the backward recomputes alpha from: the saved
tensors are just (q, k, content, lse), never a per-head output.
"""

from __future__ import annotations

import torch

from . import _build
from .flash_attention import NEG_INF

_K4 = _build.KERNELS["fused_contextualization"]
_K6 = _build.KERNELS["fused_contextualization_bwd"]


def _causal(s: int, device) -> torch.Tensor:
    pos = torch.arange(s, device=device)
    return (pos[None, :] <= pos[:, None])[None, None]


def contextualization_reference(q: torch.Tensor, k: torch.Tensor,
                                content: torch.Tensor, scale: float,
                                return_lse: bool = False):
    """Plain version of K4, O(s^2) memory: the products in the working
    dtype (content's; bf16 stays bf16), scores and softmax in f32. With
    return_lse also the (b, nv, s) f32 log-sum-exps."""
    cdt = content.dtype
    s = torch.einsum("btkd,bjkd->bktj", q.to(cdt), k.to(cdt)).float() * scale
    s = torch.where(_causal(s.shape[-1], q.device), s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    out = torch.einsum("bktj,bjkd->btd", a.to(cdt), content).to(content.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def fused_ctx_bwd_ref(q, k, content, lse, g, scale: float):
    """Plain version of K6 (JAX ``_fused_ctx_dq_delta_kernel`` :158 and
    ``_fused_ctx_dkc_kernel`` :209): alpha = exp(scale q.k - lse) (causal),
    dP = dO . c, delta = rowsum(alpha dP), dS = alpha (dP - delta);
    dq = scale dS k, dk = scale dS^T q, dcontent = alpha^T dO. Products in
    content's dtype, the rest in f32."""
    cdt = content.dtype
    g = g.to(cdt)
    s = torch.einsum("btkd,bjkd->bktj", q.to(cdt), k.to(cdt)).float() * scale
    a = torch.where(_causal(s.shape[-1], q.device),
                    torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("btd,bjkd->bktj", g, content).float()
    delta = (a * dp).sum(-1, keepdim=True)
    ds = (a * (dp - delta)).to(cdt)
    dq = torch.einsum("bktj,bjkd->btkd", ds, k.to(cdt)).float() * scale
    dk = torch.einsum("bktj,btkd->bjkd", ds, q.to(cdt)).float() * scale
    dc = torch.einsum("bktj,btd->bjkd", a.to(cdt), g)
    return dq.to(q.dtype), dk.to(k.dtype), dc.to(cdt)


def _check(q, k, content, dtypes):
    b, s, nv, dnv = q.shape
    _build.check_cuda_tensor("content", content, dtypes, 4)
    _build.check_cuda_tensor("q", q, (content.dtype,), 4)
    _build.check_cuda_tensor("k", k, (content.dtype,), 4)
    if k.shape != q.shape or content.shape[:3] != (b, s, nv):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"content {tuple(content.shape)} disagree")
    if dnv > 64:
        raise ValueError(f"fused contextualization kernels take dnv <= 64, "
                         f"got {dnv}")


def _k4_rows(b: int, s: int, d: int, sms: int = 132) -> int:
    """Query rows of each tile of K4's bf16 kernel on a card of ``sms`` SMs.

    A block owns two tiles (i and n - 1 - i, so every block does the same
    products) and 192 columns of d. At 64 rows a block reads each content
    tile once, for both its tiles at a time where both see it; at 128 rows
    each read serves 128 rows of one tile, with half the blocks. 128 is
    taken where its blocks alone fill the card (the training's 32 x 512),
    else 64 (the forward's 8 x 512: 128 blocks); see PERF.md."""
    pairs = (-(-s // 128) + 1) // 2
    return 128 if pairs * -(-d // 192) * b >= sms else 64


def _fwd_kernel(q, k, content, scale):
    """K4 (``csrc/fused_contextualization.cu``): bf16 on tensor cores (an
    LSE pass, then P @ content on wgmma over TMA loads in tiles of
    :func:`_k4_rows` query rows) when the rows of q, k and content are 16-byte
    aligned and dnv % 8 == 0, else f32 or bf16 SIMT; dnv <= 64, any outer
    strides. -> (out (b, s, d), lse (b, nv, s) f32)."""
    b, s, nv, dnv = q.shape
    d = content.shape[-1]
    _check(q, k, content, (torch.bfloat16, torch.float32))
    out = torch.empty((b, s, d), dtype=content.dtype, device=q.device)
    lse = torch.empty((b, nv, s), dtype=torch.float32, device=q.device)
    # the row LSEs in log2 units, rows padded to a multiple of 128
    s_pad = -(-s // 128) * 128
    ws = torch.empty((b * nv, s_pad), dtype=torch.float32, device=q.device)
    rows = _k4_rows(b, s, d, _build.sm_count(q.device.index))
    P = _build.Ptr.of
    _build.launch(
        _K4, "fused_contextualization_launch", P(q), P(k), P(content), P(lse),
        P(ws), P(out), b, s, nv, dnv, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        content.stride(0), content.stride(1), content.stride(2),
        s_pad, rows, float(scale), _build.DTYPE_CODE[content.dtype])
    return out, lse


def _k6_heads(b: int, s: int, nv: int, d: int, sms: int = 132) -> int:
    """Sense heads a CTA of K6's bf16 dcontent pass walks on a card of
    ``sms`` SMs.

    A CTA owns two key tiles (j and n - 1 - j: the same products for every
    CTA) and 192 columns of d, for each of its heads in turn; its ring runs
    on across the heads, so a long walk pays the ring's fill and drain once.
    The heads are spread over as few CTAs as make about four waves (the
    training's 32 x 512 at nv 16: 512 CTAs walking all 16 heads; mini's 8 x
    512: 512 CTAs of 4); see PERF.md."""
    units = b * ((-(-s // 64) + 1) // 2) * -(-d // 192) * nv
    return max(1, min(nv, -(-units // (4 * sms))))


def _bwd_kernel(q, k, content, lse, g, scale):
    """K6 (``csrc/fused_contextualization_bwd.cu``): bf16 on tensor cores
    (dnv % 8 == 0, d % 8 == 0; rows 16-byte aligned, else copied contiguous
    first): a delta pass, the dcontent pass (:func:`_k6_heads` sense heads a
    CTA) and the main pass (dP once for dq and dk) on wgmma over TMA rings,
    then dq out of its f32 accumulator; or f32 SIMT; dnv <= 64. The
    workspaces (the log2 LSE and delta tables, the f32 dq accumulator) are
    allocated here for the call. -> (dq, dk, dcontent), contiguous."""
    b, s, nv, dnv = q.shape
    d = content.shape[-1]
    _check(q, k, content, (torch.bfloat16, torch.float32))
    bf16 = content.dtype == torch.bfloat16
    if bf16 and (dnv % 8 or d % 8):
        raise ValueError(f"fused_ctx_bwd kernel takes dnv % 8 == 0 and "
                         f"d % 8 == 0 in bf16, got {dnv} and {d}")
    q, k, content, g = (_build.kernel_operand(t)
                        for t in (q, k, content, g.to(content.dtype)))
    _build.check_cuda_tensor("g", g, (content.dtype,), 3)
    if g.shape != (b, s, d):
        raise ValueError(f"g: shape {tuple(g.shape)} != {(b, s, d)}")
    _build.check_cuda_tensor("lse", lse, (torch.float32,), 3)
    lse = lse.contiguous()
    dev = q.device
    dq = torch.empty((b, s, nv, dnv), dtype=q.dtype, device=dev)
    dk = torch.empty((b, s, nv, dnv), dtype=k.dtype, device=dev)
    dc = torch.empty((b, s, nv, d), dtype=content.dtype, device=dev)
    # per (batch, head) row tables padded to whole 64-row tiles
    s_pad = -(-s // 64) * 64
    delta = torch.empty((b * nv, s_pad), dtype=torch.float32, device=dev)
    lse2 = torch.empty_like(delta) if bf16 else None
    dq_acc = (torch.empty((b, s, nv, dnv), dtype=torch.float32, device=dev)
              if bf16 else None)
    P = _build.Ptr.of
    _build.launch(
        _K6, "fused_contextualization_bwd_launch", P(q), P(k), P(content),
        P(g), P(lse), P(lse2), P(delta), P(dq_acc), P(dq), P(dk), P(dc),
        b, s, nv, dnv, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        content.stride(0), content.stride(1), content.stride(2),
        g.stride(0), g.stride(1), s_pad,
        _k6_heads(b, s, nv, d, _build.sm_count(dev.index)), float(scale),
        _build.DTYPE_CODE[content.dtype])
    return dq, dk, dc


def fused_ctx_bwd(q, k, content, lse, g, scale: float):
    """Gradients (dq, dk, dcontent) of the fused contextualization. CPU
    tensors, and every call inside ``_build.plain_path()``, take
    :func:`fused_ctx_bwd_ref`; otherwise a CUDA tensor launches K6 (bf16
    or f32) or raises."""
    fn = (_bwd_kernel if q.is_cuda and _build.kernels_enabled()
          else fused_ctx_bwd_ref)
    return fn(q, k, content, lse, g, scale)


class _FusedContextualization(torch.autograd.Function):
    """K4 forward (with its LSE), K6 backward: the counterpart of the JAX
    ``custom_vjp`` (:423-452). The path (kernel or plain) is decided once,
    at the forward, as in ``flash_attention._FlashAttention``."""

    @staticmethod
    def forward(ctx, q, k, content, scale, use_kernel):
        if use_kernel:
            out, lse = _fwd_kernel(q, k, content, scale)
        else:
            out, lse = contextualization_reference(q, k, content, scale,
                                                   return_lse=True)
        ctx.save_for_backward(q, k, content, lse)
        ctx.scale, ctx.use_kernel = scale, use_kernel
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, content, lse = ctx.saved_tensors
        fn = _bwd_kernel if ctx.use_kernel else fused_ctx_bwd_ref
        dq, dk, dc = fn(q, k, content, lse, g, ctx.scale)
        return dq, dk, dc, None, None


def fused_contextualization(q: torch.Tensor, k: torch.Tensor,
                            content: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """q, k (b, s, nv, dnv); content (b, s, nv, d) -> (b, s, d) in content's
    dtype, differentiable in q, k and content. CPU tensors, and every call
    inside ``_build.plain_path()``, take :func:`contextualization_reference`
    (and :func:`fused_ctx_bwd_ref` backward); otherwise a CUDA tensor
    launches K4 (and K6 backward) or raises."""
    use_kernel = q.is_cuda and _build.kernels_enabled()
    return _FusedContextualization.apply(q, k, content, float(scale),
                                         use_kernel)
