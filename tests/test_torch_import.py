"""The port's checkpoint import (utils/torch_import.py, utils/pretrained.py)
against the JAX package's, on the CPU.

A reference-format state dict (the JAX package's export of seeded
``backpack_test()`` weights) is ``torch.save``d as a Lightning checkpoint
and imported by both packages: the port's tree must equal
``params_from_numpy`` of JAX's import leaf for leaf (f32 and bf16, bit for
bit), and the logits agree to ``atol=1e-5`` at f32.
"""

import json
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu import config as jcfg
from backpacks_flash_attn_tpu.models import backpack as jbp
from backpacks_flash_attn_tpu.models import gpt as jgpt
from backpacks_flash_attn_tpu.utils import torch_import as jti
from backpacks_flash_attn_tpu_torch import config as tcfg
from backpacks_flash_attn_tpu_torch.models import backpack as tbp
from backpacks_flash_attn_tpu_torch.utils import pretrained as tpt
from backpacks_flash_attn_tpu_torch.utils import torch_import as tti
from backpacks_flash_attn_tpu_torch.utils.weights import params_from_numpy

torch.set_num_threads(1)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in g:
        assert g[k].dtype == w[k].dtype, k
        assert torch.equal(g[k], w[k]), k


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    jc = jcfg.backpack_test()
    jparams = jbp.init_backpack(jc, jax.random.PRNGKey(3))
    sd = jti.state_dict_from_backpack_params(jparams, jc)
    path = tmp_path_factory.mktemp("ckpt") / "last.ckpt"
    torch.save({"state_dict": {"model." + k: torch.from_numpy(np.array(v))
                               for k, v in sd.items()},
                "epoch": 3}, str(path))
    return str(path), sd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_backpack_checkpoint_matches_jax(ckpt, dtype):
    path, _ = ckpt
    jc, tc = jcfg.backpack_test(), tcfg.backpack_test()
    jparams = jti.load_backpack_checkpoint(path, jc, dtype=getattr(jnp, dtype))
    tparams = tti.load_backpack_checkpoint(path, tc, dtype=getattr(torch, dtype),
                                           device="cpu")
    want = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    _trees_equal(tparams, want)
    if dtype == "float32":
        ids = np.random.default_rng(0).integers(0, 512, (2, 12)).astype(np.int32)
        jl = jbp.backpack_forward(jparams, jc, jnp.asarray(ids), use_flash=False)
        tl = tbp.backpack_forward(tparams, tc, torch.from_numpy(ids).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)


def test_state_dict_round_trip_matches_jax(ckpt):
    """The port's export of the imported tree equals the JAX package's
    export (the file's state dict) bit for bit, and re-imports equal."""
    path, sd = ckpt
    tc = tcfg.backpack_test()
    tparams = tti.load_backpack_checkpoint(path, tc, device="cpu")
    back = tti.state_dict_from_backpack_params(tparams, tc)
    assert back.keys() == sd.keys()
    for k in sd:
        assert back[k].dtype == np.float32, k
        np.testing.assert_array_equal(back[k], np.asarray(sd[k]), err_msg=k)
    _trees_equal(tti.backpack_params_from_state_dict(back, tc, device="cpu"),
                 tparams)


def test_gpt_imports_match_jax(tmp_path):
    """gpt_params_from_state_dict (load_gpt_checkpoint) and
    gpt_params_from_hf_gpt2 on the same random state dicts as JAX's."""
    jc, tc = jcfg.gpt2_test(), tcfg.gpt2_test()
    rng = np.random.default_rng(5)
    jparams = jgpt.init_gpt(jc, jax.random.PRNGKey(2))
    # the reference layout, from JAX's Backpack export's GPT half
    sd = {}
    d, L = jc.n_embd, jc.n_layer
    sd["transformer.embeddings.word_embeddings.weight"] = rng.normal(
        size=(jc.vocab_size, d)).astype(np.float32)
    sd["transformer.embeddings.position_embeddings.weight"] = rng.normal(
        size=(jc.n_positions, d)).astype(np.float32)
    for name in ("ln_0",):
        sd[f"transformer.{name}.weight"] = rng.normal(size=d).astype(np.float32)
        sd[f"transformer.{name}.bias"] = rng.normal(size=d).astype(np.float32)
    shapes = {"mixer.Wqkv": (3 * d, d), "mixer.out_proj": (d, d),
              "mlp.fc1": (4 * d, d), "mlp.fc2": (d, 4 * d)}
    for i in range(L):
        for name, shp in shapes.items():
            sd[f"transformer.layers.{i}.{name}.weight"] = rng.normal(size=shp).astype(np.float32)
            sd[f"transformer.layers.{i}.{name}.bias"] = rng.normal(size=shp[0]).astype(np.float32)
        for name in ("norm1", "norm2"):
            sd[f"transformer.layers.{i}.{name}.weight"] = rng.normal(size=d).astype(np.float32)
            sd[f"transformer.layers.{i}.{name}.bias"] = rng.normal(size=d).astype(np.float32)
    path = tmp_path / "gpt.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))
    want = params_from_numpy(jax.tree.map(
        np.asarray, jti.load_gpt_checkpoint(str(path), jc)), device="cpu")
    _trees_equal(tti.load_gpt_checkpoint(str(path), tc, device="cpu"), want)
    assert jax.tree.structure(jparams) == jax.tree.structure(
        jti.load_gpt_checkpoint(str(path), jc))

    hf = {"wte.weight": rng.normal(size=(jc.vocab_size, d)),
          "wpe.weight": rng.normal(size=(jc.n_positions, d)),
          "ln_f.weight": rng.normal(size=d), "ln_f.bias": rng.normal(size=d)}
    for i in range(L):
        for name, shp in {"attn.c_attn": (d, 3 * d), "attn.c_proj": (d, d),
                          "mlp.c_fc": (d, 4 * d), "mlp.c_proj": (4 * d, d)}.items():
            hf[f"h.{i}.{name}.weight"] = rng.normal(size=shp)
            hf[f"h.{i}.{name}.bias"] = rng.normal(size=shp[1])
        for name in ("ln_1", "ln_2"):
            hf[f"h.{i}.{name}.weight"] = rng.normal(size=d)
            hf[f"h.{i}.{name}.bias"] = rng.normal(size=d)
    hf = {k: v.astype(np.float32) for k, v in hf.items()}
    for dtype in ("float32", "bfloat16"):
        want = params_from_numpy(jax.tree.map(np.asarray, jti.gpt_params_from_hf_gpt2(
            hf, jc, dtype=getattr(jnp, dtype))), device="cpu")
        got = tti.gpt_params_from_hf_gpt2({k: torch.from_numpy(v) for k, v in hf.items()},
                                          tc, dtype=getattr(torch, dtype), device="cpu")
        _trees_equal(got, want)


def _write_safetensors(path, tensors):
    """A safetensors file by the format's spec: BF16 leaves from torch
    tensors, the rest from numpy arrays."""
    header, bufs, off = {}, [], 0
    for name, t in tensors.items():
        if isinstance(t, torch.Tensor):
            code, b = "BF16", t.contiguous().view(torch.int16).numpy().tobytes()
        else:
            code, b = {np.float32: "F32", np.int64: "I64"}[t.dtype.type], t.tobytes()
        header[name] = {"dtype": code, "shape": list(t.shape),
                        "data_offsets": [off, off + len(b)]}
        bufs.append(b)
        off += len(b)
    hb = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hb)) + hb + b"".join(bufs))


def test_resolve_pretrained_and_safetensors_bf16(ckpt, tmp_path, monkeypatch):
    """resolve_pretrained on a file and on a directory (its first weight
    candidate); a BF16 safetensors file read without ml_dtypes or
    safetensors gives the JAX package's f32 values, and its import the same
    bf16 tree as the .ckpt's."""
    path, sd = ckpt
    assert tpt.resolve_pretrained(path) == path
    (tmp_path / "pytorch_model.bin").write_bytes(open(path, "rb").read())
    assert tpt.resolve_pretrained(str(tmp_path)) == str(tmp_path / "pytorch_model.bin")
    got = tpt.state_dict_from_pretrained(str(tmp_path))
    assert got.keys() == sd.keys()
    with pytest.raises(FileNotFoundError):
        tpt.resolve_pretrained(str(tmp_path), filename="missing.bin")

    bf = {k: torch.from_numpy(np.array(v)).to(torch.bfloat16) for k, v in sd.items()}
    bf["step"] = np.arange(3, dtype=np.int64)
    st = tmp_path / "w" / "model.safetensors"
    st.parent.mkdir()
    _write_safetensors(str(st), bf)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    out = tpt.state_dict_from_pretrained(str(st.parent))
    np.testing.assert_array_equal(out["step"], np.arange(3))
    for k in sd:
        assert out[k].dtype == np.float32
        np.testing.assert_array_equal(out[k], bf[k].float().numpy(), err_msg=k)
    tc = tcfg.backpack_test()
    _trees_equal(tti.backpack_params_from_state_dict(out, tc, dtype=torch.bfloat16,
                                                     device="cpu"),
                 tti.load_backpack_checkpoint(path, tc, dtype=torch.bfloat16,
                                              device="cpu"))
