"""Pretrained-checkpoint resolution: local paths, local caches, and the HF hub.

Port of ``backpacks_flash_attn_tpu/utils/pretrained.py`` (reference:
flash_attn/utils/pretrained.py:7-8, ``state_dict_from_pretrained`` =
``torch.load(cached_file(model_name, WEIGHTS_NAME))``). Resolution is
layered so the same call works offline and online:

  1. an existing filesystem path is used as-is (a directory: the first of
     WEIGHT_CANDIDATES in it)
  2. the local HF cache is consulted WITHOUT network (``huggingface_hub``,
     imported only here)
  3. only then a hub download is attempted; failures raise
     FileNotFoundError

The resolved file feeds utils/torch_import.py, e.g.:

    sd = state_dict_from_pretrained("gpt2")
    params = gpt_params_from_hf_gpt2(sd, cfg)

``.safetensors`` files are read by a small reader of their own (header
json + raw buffers): neither the ``safetensors`` package nor ``ml_dtypes``
is needed, BF16 leaves are read through ``torch.frombuffer``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional

import numpy as np
import torch

WEIGHT_CANDIDATES = ("pytorch_model.bin", "model.safetensors")


def resolve_pretrained(model_name: str,
                       filename: Optional[str] = None) -> str:
    """Return a local file path for `model_name`'s weights (see module doc
    for the resolution order). Raises FileNotFoundError when unreachable."""
    if os.path.exists(model_name):
        if os.path.isdir(model_name):
            for cand in ([filename] if filename else WEIGHT_CANDIDATES):
                p = os.path.join(model_name, cand)
                if os.path.exists(p):
                    return p
            raise FileNotFoundError(
                f"no weight file in {model_name!r} (tried "
                f"{filename or WEIGHT_CANDIDATES})")
        return model_name

    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise FileNotFoundError(
            f"{model_name!r} is not a local path and huggingface_hub is "
            f"unavailable") from e

    candidates = [filename] if filename else list(WEIGHT_CANDIDATES)
    errors = []
    for local_only in (True, False):  # cache first: no egress needed offline
        for cand in candidates:
            try:
                return hf_hub_download(model_name, cand,
                                       local_files_only=local_only)
            except Exception as e:    # cache miss / no network / no file
                errors.append(f"{cand} (local_only={local_only}): {e}")
    raise FileNotFoundError(
        f"could not resolve pretrained weights for {model_name!r}:\n  "
        + "\n  ".join(str(e)[:200] for e in errors))


def state_dict_from_pretrained(model_name: str,
                               filename: Optional[str] = None
                               ) -> Dict[str, np.ndarray]:
    """Weights for `model_name` as a flat numpy state dict (the reference's
    state_dict_from_pretrained, utils/pretrained.py:7-8)."""
    path = resolve_pretrained(model_name, filename)
    if path.endswith(".safetensors"):
        return _load_safetensors(path)
    from .torch_import import load_torch_checkpoint
    return load_torch_checkpoint(path)


_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
           "I64": np.int64, "I32": np.int32, "I16": np.int16,
           "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def _load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Minimal safetensors reader (an 8-byte little-endian header length,
    the json header, the raw buffers). BF16 leaves come back as float32
    (exact), the rest in their own dtype."""
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(n))
        base = f.tell()
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            start, end = meta["data_offsets"]
            f.seek(base + start)
            buf = bytearray(f.read(end - start))
            if meta["dtype"] == "BF16":
                t = torch.frombuffer(buf, dtype=torch.bfloat16) if buf else \
                    torch.empty((0,), dtype=torch.bfloat16)
                out[name] = t.float().numpy().reshape(meta["shape"])
            elif meta["dtype"] in _DTYPES:
                out[name] = np.frombuffer(
                    bytes(buf), dtype=_DTYPES[meta["dtype"]]).reshape(
                        meta["shape"])
            else:
                raise ValueError(f"unsupported dtype {meta['dtype']}")
    return out
