"""The weight bridge: parameter trees with numpy leaves <-> the port's trees.

The JAX package's parameter tree, with numpy leaves (what
``jax.tree.map(np.asarray, params)`` gives), has the port's layout: nested
dicts, kernels ``(in, out)``, layers stacked on a leading axis. Quantized
leaves are read by duck typing (``q/scale/bias/bits/d_out`` for a linear,
``q/scale/bits`` for a gather table), so a test can feed both packages
bit-identical INT8 weights without this module importing JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops import _build
from ..ops.quant import QuantTable, QuantWeight


def _to_tensor(x, device, dtype) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":       # ml_dtypes bfloat16: via exact f32
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))    # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Any, device="cuda", dtype=None) -> Any:
    """Numpy-leaved tree -> tensor tree on ``device``. dtype, if given,
    casts the floating-point leaves of fp layers (quantized leaves keep
    their int8 codes and f32 scales)."""
    device = _build.resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if all(hasattr(tree, a) for a in ("q", "scale", "bias", "bits", "d_out")):
        return QuantWeight(
            q=_to_tensor(tree.q, device, None),
            scale=_to_tensor(tree.scale, device, None),
            bias=None if tree.bias is None else _to_tensor(tree.bias, device,
                                                           dtype),
            bits=int(tree.bits), d_out=int(tree.d_out))
    if all(hasattr(tree, a) for a in ("q", "scale", "bits")):
        return QuantTable(q=_to_tensor(tree.q, device, None),
                          scale=_to_tensor(tree.scale, device, None),
                          bits=int(tree.bits))
    return _to_tensor(tree, device, dtype)



def leaf_to_numpy(x) -> np.ndarray:
    """A tensor (bf16 as f32) or array-like leaf as a numpy array (the HF
    state dicts the models' remaps read)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def stack_numpy(trees) -> Any:
    """Per-layer numpy trees (nested dicts) stacked on a leading axis."""
    if isinstance(trees[0], dict):
        return {k: stack_numpy([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def params_to_numpy(tree: Any) -> Any:
    """The inverse of :func:`params_from_numpy` for floating-point trees:
    tensor tree -> numpy-leaved tree (bf16 leaves as f32), so a test can
    compare gradients and updated parameters leaf by leaf with the JAX
    package's tree."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def to_device(tree: Any, device) -> Any:
    """A tensor tree (nested dicts) moved to ``device`` (a restored
    checkpoint's CPU tensors to the card)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
