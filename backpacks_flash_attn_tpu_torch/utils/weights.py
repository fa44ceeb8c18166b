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

