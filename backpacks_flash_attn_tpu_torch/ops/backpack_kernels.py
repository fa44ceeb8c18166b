"""Fused Backpack contextualization (kernel K4), inference only.

Port of the inference forward of
``backpacks_flash_attn_tpu/ops/backpack_kernels.py`` (``fused_contextualization``
:424 -> ``_fused_ctx_infer`` :281 -> ``_fused_ctx_infer_kernel`` :119):

    out[b,t,:] = sum_k causal_softmax_j(scale * q[b,t,k] . k[b,j,k]) @ content[b,j,k,:]

without materializing alpha (b, nv, s, s). The training forward and
backward (with the per-head LSE) come with the training slice.
"""

from __future__ import annotations

import torch

from . import _build
from .flash_attention import NEG_INF

_K4 = _build.KERNELS["fused_contextualization"]


def contextualization_reference(q: torch.Tensor, k: torch.Tensor,
                                content: torch.Tensor,
                                scale: float) -> torch.Tensor:
    """Plain version of K4, O(s^2) memory: the products in the working
    dtype (content's; bf16 stays bf16), scores and softmax in f32."""
    cdt = content.dtype
    s = torch.einsum("btkd,bjkd->bktj", q.to(cdt), k.to(cdt)).float() * scale
    sq = s.shape[-1]
    pos = torch.arange(sq, device=q.device)
    s = torch.where((pos[None, :] <= pos[:, None])[None, None], s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    return torch.einsum("bktj,bjkd->btd", a.to(cdt), content).to(content.dtype)


def fused_contextualization(q: torch.Tensor, k: torch.Tensor,
                            content: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """q, k (b, s, nv, dnv); content (b, s, nv, d) -> (b, s, d) in content's
    dtype. CPU tensors, and every call inside ``_build.plain_path()``, take
    :func:`contextualization_reference`; otherwise a CUDA tensor launches
    K4 (``csrc/fused_contextualization.cu``: bf16 on tensor cores when the
    rows of q, k and content are 16-byte aligned and dnv % 8 == 0, else f32
    or bf16 SIMT; dnv <= 64, any outer strides) or raises."""
    if not q.is_cuda or not _build.kernels_enabled():
        return contextualization_reference(q, k, content, scale)
    b, s, nv, dnv = q.shape
    d = content.shape[-1]
    dtypes = (torch.bfloat16, torch.float32)
    _build.check_cuda_tensor("content", content, dtypes, 4)
    _build.check_cuda_tensor("q", q, (content.dtype,), 4)
    _build.check_cuda_tensor("k", k, (content.dtype,), 4)
    if k.shape != q.shape or content.shape[:3] != (b, s, nv):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"content {tuple(content.shape)} disagree")
    if dnv > 64:
        raise ValueError(f"fused_contextualization kernel takes dnv <= 64, "
                         f"got {dnv}")
    out = torch.empty((b, s, d), dtype=content.dtype, device=q.device)
    # the tensor-core path's per-(row, head) log-sum-exps
    lse = torch.empty((b, nv, s), dtype=torch.float32, device=q.device)
    P = _build.Ptr.of
    _build.launch(
        _K4, "fused_contextualization_launch", P(q), P(k), P(content), P(lse),
        P(out), b, s, nv, dnv, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        content.stride(0), content.stride(1), content.stride(2),
        float(scale), _build.DTYPE_CODE[content.dtype])
    return out
