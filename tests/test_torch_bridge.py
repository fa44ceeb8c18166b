"""The port's boundary: the weight bridge, JAX-free imports, the card as
the default device, and the kernel wrappers' CPU path.

The PyTorch port (backpacks_flash_attn_tpu_torch) must import no JAX and
nothing of the JAX package, allocate on CUDA unless asked for the CPU, and
take a kernel's plain version only for tensors that lie on the CPU.
"""

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu import config as jcfg
from backpacks_flash_attn_tpu.models import backpack as jbp
from backpacks_flash_attn_tpu.models import quantized as jqz
from backpacks_flash_attn_tpu_torch import config as tcfg
from backpacks_flash_attn_tpu_torch.models import backpack as tbp
from backpacks_flash_attn_tpu_torch.models import gpt as tgpt
from backpacks_flash_attn_tpu_torch.ops import _build
from backpacks_flash_attn_tpu_torch.ops import backpack_kernels as tbk
from backpacks_flash_attn_tpu_torch.ops import decode_attention as tda
from backpacks_flash_attn_tpu_torch.ops import flash_attention as tfa
from backpacks_flash_attn_tpu_torch.ops import quant as tq
from backpacks_flash_attn_tpu_torch.utils import generation as tgen
from backpacks_flash_attn_tpu_torch.utils.weights import params_from_numpy

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "backpacks_flash_attn_tpu_torch"


@pytest.fixture(scope="module")
def jax_params():
    return jbp.init_backpack(jcfg.backpack_test(), jax.random.PRNGKey(0))


def _to_numpy(tree):
    """The port's tree with numpy leaves (bf16 as f32), for comparison."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tq.QuantWeight, tq.QuantTable)):
        fields = {f: _to_numpy(getattr(tree, f)) for f in ("q", "scale")}
        if isinstance(tree, tq.QuantWeight):
            fields["bias"] = None if tree.bias is None else _to_numpy(tree.bias)
        return type(tree)(**fields, **{f: getattr(tree, f) for f in
                                      ("bits", "d_out") if hasattr(tree, f)})
    return tree.float().numpy() if tree.dtype == torch.bfloat16 else tree.numpy()


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (tq.QuantWeight, tq.QuantTable)) or hasattr(tree, "q"):
        yield f"{path}.q", np.asarray(tree.q)
        yield f"{path}.scale", np.asarray(tree.scale)
        if getattr(tree, "bias", None) is not None:
            yield f"{path}.bias", np.asarray(tree.bias)
    else:
        yield path, np.asarray(tree, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_round_trips_fp_tree(jax_params, dtype):
    jp = jax.tree.map(lambda x: x.astype(getattr(jnp, dtype)), jax_params)
    np_tree = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(np_tree, device="cpu")
    assert tp["gpt"]["layers"]["Wqkv"]["kernel"].dtype == getattr(torch, dtype)
    assert tp["gpt"]["layers"]["Wqkv"]["kernel"].shape == (2, 64, 192)
    back = dict(_leaves(_to_numpy(tp)))
    want = dict(_leaves(np_tree))
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_params_from_numpy_round_trips_quantized_tree(jax_params):
    jq = jqz.quantize_backpack_params(jax_params, jcfg.backpack_test(), bits=8)
    np_tree = jax.tree.map(np.asarray, jq)
    tp = params_from_numpy(np_tree, device="cpu")
    w = tp["gpt"]["layers"]["Wqkv"]
    assert isinstance(w, tq.QuantWeight) and w.q.dtype == torch.int8
    assert (w.bits, w.d_out) == (8, 192) and w.q.shape == (2, 64, 256)
    assert isinstance(tp["content"]["table"], tq.QuantTable)
    back = dict(_leaves(_to_numpy(tp)))
    want = dict(_leaves(np_tree))
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], np.asarray(v, back[k].dtype),
                                      err_msg=k)


def test_port_imports_no_jax():
    """Statically: no import of jax or of the JAX package in the port or
    chip_smoke.py. Dynamically: with both blocked, the port imports and
    runs a tiny CPU forward and cached decode step."""
    pattern = re.compile(r"^\s*(import|from) +(jax|backpacks_flash_attn_tpu)\b",
                         re.M)
    for path in [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path
    code = """
import sys
sys.modules["jax"] = None
sys.modules["backpacks_flash_attn_tpu"] = None
import torch
from backpacks_flash_attn_tpu_torch.config import backpack_test
from backpacks_flash_attn_tpu_torch.models import backpack as bp
cfg = backpack_test()
params = bp.init_backpack(cfg, torch.Generator().manual_seed(0), device="cpu")
ids = torch.randint(0, cfg.vocab_size, (2, 6))
logits = bp.backpack_forward(params, cfg, ids)
cache = bp.init_backpack_cache(cfg, 2, 16, torch.float32, device="cpu")
step, _ = bp.backpack_forward_with_cache(params, cfg, ids, cache)
assert torch.allclose(step, logits, atol=1e-5), (step - logits).abs().max()
assert "jax" not in {m.split(".")[0] for m, v in sys.modules.items() if v}
print("ok", tuple(logits.shape))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, timeout=300,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert "ok (2, 6, 512)" in out.stdout


def test_entry_points_default_to_cuda_and_raise_without_it(jax_params):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = tcfg.backpack_test()
    gen = torch.Generator().manual_seed(0)
    np_tree = jax.tree.map(np.asarray, jax_params)
    params = params_from_numpy(np_tree, device="cpu")
    ids = torch.zeros((1, 3), dtype=torch.long)
    calls = [
        lambda: tbp.init_backpack(cfg, gen),
        lambda: tgpt.init_gpt(cfg, gen),
        lambda: tbp.init_backpack_cache(cfg, 1, 8),
        lambda: tgpt.init_kv_cache(cfg, 1, 8),
        lambda: params_from_numpy(np_tree),
        lambda: tgen.generate_backpack(params, cfg, ids, 6),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            call()


def test_wrappers_take_plain_path_on_cpu_and_count_no_launch():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    _build.reset_launches()
    q, kt, v = r(4, 8), r(4, 8, 10), r(4, 10, 12)
    assert torch.equal(tda.decode_attention(q, kt, None, v, None, 7),
                       tda.decode_attention_ref(q, kt, None, v, None, 7))
    qw = tq.quantize_weight(r(32, 40))
    x = r(3, 32)
    assert torch.equal(tq.quant_matmul(x, qw), tq.quant_matmul_ref(x, qw))
    a, b, c = r(2, 5, 2, 16), r(2, 7, 2, 16), r(2, 7, 2, 16)
    lens = torch.tensor([7, 4])
    assert torch.equal(
        tfa.flash_attention(a, b, c, seq_lengths=lens, q_offsets=2),
        tfa.flash_attention_ref(a, b, c, seq_lengths=lens, q_offsets=2))
    qc, kc, cc = r(2, 6, 3, 4), r(2, 6, 3, 4), r(2, 6, 3, 8)
    assert torch.equal(tbk.fused_contextualization(qc, kc, cc, 0.5),
                       tbk.contextualization_reference(qc, kc, cc, 0.5))
    assert _build.launch_counts() == {k: 0 for k in _build.KERNELS}
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(a, b, c, dropout_p=0.1)


def test_plain_path_switch_is_scoped():
    assert _build.kernels_enabled()
    with _build.plain_path():
        assert not _build.kernels_enabled()
    assert _build.kernels_enabled()


def test_backpack_module_matches_functions(jax_params):
    cfg = tcfg.backpack_test()
    params = params_from_numpy(jax.tree.map(np.asarray, jax_params),
                               device="cpu")
    model = tbp.BackpackLM(cfg, params)
    ids = torch.randint(0, cfg.vocab_size, (2, 5),
                        generator=torch.Generator().manual_seed(1))
    assert torch.equal(model(ids), tbp.backpack_forward(params, cfg, ids))
    assert "gpt__layers__Wqkv__kernel" in dict(model.named_buffers())
    qmodel = model.quantized(bits=8)
    assert isinstance(qmodel.params["gpt"]["lm_head"], tq.QuantWeight)
    cache = qmodel.init_cache(2, 16, torch.int8)
    logits, cache = qmodel.step(ids, cache)
    assert logits.dtype == torch.float32 and cache.length == 5
    assert torch.isfinite(logits).all()
