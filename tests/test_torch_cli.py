"""The port's REPL (cli.py) and ``quant_gates --checkpoint`` against the JAX
package's, on the CPU.

Both REPLs load the same reference-format checkpoint of seeded
``backpack-test`` weights (bf16, as the CLI loads them) and read the same
scripted stdin: prompts of token ids, ``/upweight``, ``/edit``,
``/senses``, ``/reset``. Every reply line, greedy continuations included,
must be equal. The port runs with ``--device cpu`` (the kernels' plain
versions).

The JAX side (the checkpoint, its REPL runs and its ``quant_gates``) runs
once, in a subprocess of its own: the JAX REPL runs op by op and loads
some 800 executables, and XLA:CPU fails after too many in one process
(pytest.ini), which would otherwise fall on whichever test file the
worker runs next.
"""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu import config as jcfg
from backpacks_flash_attn_tpu.utils import torch_import as jti
from backpacks_flash_attn_tpu_torch import cli as tcli
from backpacks_flash_attn_tpu_torch.eval import quant_gates as tgates
from backpacks_flash_attn_tpu_torch.training import checkpoint as tckpt

torch.set_num_threads(1)

SCRIPT = """3 1 4 1 5 9 2 6
/upweight 9 3.0
3 1 4 1 5 9 2 6
/edit 9 3 5
9 2 6 5 3 5
/senses 9
/bogus
/reset
2 7 1 8 2 8
/quit
never read
"""


REPL_ARGV = ["--model", "backpack-test", "--max-new-tokens", "6"]
GATES_ARGV = ["--model", "backpack-test", "--seqlen", "16", "--max-batches", "1",
              "--val-fraction", "0.05"]

# The JAX side, run by ``python -c`` with argv [directory]: the checkpoint
# (seeded backpack-test weights; larger embeddings and senses spread the
# logits, so a greedy token is decided well above bf16 rounding in both
# packages), the REPL's replies to SCRIPT (bf16 and --int8) and the quant
# gates' last line on a corpus the parent wrote -> json on stdout.
JAX_SIDE = """
import io, json, sys
from contextlib import redirect_stdout
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import torch
from backpacks_flash_attn_tpu import cli, config
from backpacks_flash_attn_tpu.eval import quant_gates
from backpacks_flash_attn_tpu.models import backpack
from backpacks_flash_attn_tpu.utils import torch_import
d = sys.argv[1]
spec = json.load(open(d + "/spec.json"))
jc = config.backpack_test()
p = backpack.init_backpack(jc, jax.random.PRNGKey(7))
p["gpt"]["wte"] = p["gpt"]["wte"] * 20.0
fc2 = p["content"]["final_mlp"]["fc2"]
fc2["kernel"] = fc2["kernel"] * 20.0
sd = torch_import.state_dict_from_backpack_params(p, jc)
torch.save({"state_dict": {"model." + k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}}, d + "/last.ckpt")
out = {}
for name, argv in spec["repl"].items():
    sys.stdin = io.StringIO(spec["script"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.main(argv)
    out[name] = buf.getvalue().splitlines()
buf = io.StringIO()
with redirect_stdout(buf):
    quant_gates.main(spec["gates"])
out["gates"] = json.loads(buf.getvalue().strip().splitlines()[-1])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """(checkpoint path, corpus path, the JAX side's outputs by name)."""
    from backpacks_flash_attn_tpu_torch.data import lm_dataset as lmd
    d = tmp_path_factory.mktemp("cli")
    ckpt = str(d / "last.ckpt")
    corpus = lmd.save_corpus(
        np.random.default_rng(9).integers(0, 512, 800).astype(np.uint16), str(d), "c")
    base = REPL_ARGV + ["--checkpoint", ckpt]
    (d / "spec.json").write_text(json.dumps(dict(
        script=SCRIPT, repl={"bf16": base, "int8": base + ["--int8"]},
        gates=GATES_ARGV + ["--checkpoint", ckpt, "--corpus", corpus])))
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]),
               JAX_COMPILATION_CACHE_DIR=jax.config.jax_compilation_cache_dir or "",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0.1")
    run = subprocess.run([sys.executable, "-c", JAX_SIDE, str(d)], env=env, cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return ckpt, corpus, json.loads(run.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ckpt(jax_side):
    return jax_side[0]


def _run(main, argv, script, monkeypatch):
    monkeypatch.setattr("sys.stdin", io.StringIO(script))
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("int8", [False, True])
def test_repl_replies_equal_jax(jax_side, int8, monkeypatch):
    ckpt, _, jax_out = jax_side
    argv = REPL_ARGV + ["--checkpoint", ckpt] + (["--int8"] if int8 else [])
    want = jax_out["int8" if int8 else "bf16"]
    got = _run(tcli.main, argv + ["--device", "cpu"], SCRIPT, monkeypatch)
    assert len(want) == 13   # banner, 4 continuations, 4 sense lines, 4 replies
    assert got == want


def test_repl_loads_npz_like_ckpt(ckpt, tmp_path, monkeypatch):
    """A .npz of the port's checkpoint format and the .ckpt give the same
    continuations. Sampling draws from utils.prng keys split per prompt:
    the same seed gives the same tokens, another seed others. (JAX samples
    the bf16 logits in bf16 and the port in f32, so sampled tokens of bf16
    weights are not compared with JAX's.)"""
    tc = tcli.MODELS["backpack-test"]()
    from backpacks_flash_attn_tpu_torch.utils import torch_import as tti
    params = tti.load_backpack_checkpoint(ckpt, tc, dtype=torch.bfloat16,
                                          device="cpu")
    npz = tckpt.save(str(tmp_path), params, step=0, name="w.ckpt.npz")
    script = "3 1 4 1 5\n2 7 1\n"
    base = ["--model", "backpack-test", "--max-new-tokens", "5",
            "--device", "cpu"]
    a = _run(tcli.main, base + ["--checkpoint", ckpt], script, monkeypatch)
    b = _run(tcli.main, base + ["--checkpoint", npz], script, monkeypatch)
    assert a == b and len(a) == 3
    samp = ["--checkpoint", npz, "--temperature", "0.9", "--top-k", "20"]
    s3 = _run(tcli.main, base + samp + ["--seed", "3"], script, monkeypatch)
    assert s3 == _run(tcli.main, base + samp + ["--seed", "3"], script,
                      monkeypatch)
    assert s3 != _run(tcli.main, base + samp + ["--seed", "4"], script,
                      monkeypatch)
    assert s3 != a


def test_quant_gates_checkpoint_matches_jax(jax_side):
    ckpt, corpus, jax_out = jax_side
    argv = GATES_ARGV + ["--checkpoint", ckpt, "--corpus", corpus, "--device", "cpu"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        tgates.main(argv)
    jout, tout = jax_out["gates"], json.loads(buf.getvalue().strip().splitlines()[-1])
    assert tout.keys() == jout.keys() and tout["checkpoint_step"] == -1
    for k, jv in jout.items():
        if isinstance(jv, bool) or k in ("checkpoint_step", "int4_head_bits"):
            assert tout[k] == jv, k
        elif k.endswith("_ppl"):
            np.testing.assert_allclose(tout[k], jv, rtol=2e-2, err_msg=k)


def test_generate_backpack_sense_edit_matches_jax(ckpt):
    """generate_backpack(sense_edit=) (the REPL's /edit) against JAX's at
    f32: the same edit of mogrify_word, the same greedy ids, scores to 1e-4
    (the bf16 REPL's /edit is test_repl_replies_equal_jax)."""
    import jax.numpy as jnp
    from backpacks_flash_attn_tpu.models import interventions as jiv
    from backpacks_flash_attn_tpu.utils import generation as jgen
    from backpacks_flash_attn_tpu_torch.models import interventions as tiv
    from backpacks_flash_attn_tpu_torch.utils import generation as tgen
    from backpacks_flash_attn_tpu_torch.utils.weights import params_from_numpy
    jc = jcfg.backpack_test()
    jparams = jti.load_backpack_checkpoint(ckpt, jc)         # f32, as written
    tc = tcli.MODELS["backpack-test"]()
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    ids = np.random.default_rng(6).integers(0, 512, (2, 7)).astype(np.int32)
    ids[:, 2] = 9
    jedit = jiv.mogrify_word(jparams, jc, 9, 3, 5)
    tedit = tiv.mogrify_word(tparams, tc, 9, 3, 5)
    want = jgen.generate_backpack(jparams, jc, jnp.asarray(ids), 13,
                                  sense_edit=jedit, output_scores=True,
                                  cache_dtype=jnp.float32, use_flash=False)
    got = tgen.generate_backpack(tparams, tc, torch.from_numpy(ids).long(), 13,
                                 sense_edit=tedit, output_scores=True,
                                 cache_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(got.sequences.numpy(), np.asarray(want.sequences))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4, rtol=0)
    plain = tgen.generate_backpack(tparams, tc, torch.from_numpy(ids).long(), 13,
                                   cache_dtype=torch.float32, device="cpu")
    assert not torch.equal(plain.sequences, got.sequences)


def test_sense_weights_reach_the_decode_kernels_contiguous():
    """The REPL's /upweight decodes one prompt (b = 1) over a bf16 cache,
    where the (E, S) sense weights are K1's value scales, which the kernel
    reads with a unit inner stride: every form of the weights comes out
    contiguous, with the values of the plain broadcast."""
    from backpacks_flash_attn_tpu_torch.models import backpack as tbp
    nv, S = 4, 10
    forms = [torch.rand(nv), torch.rand(1, nv), torch.rand(3, nv),
             torch.rand(1, S, nv), torch.rand(2, S, nv)]
    for w in forms:
        b = 1 if w.dim() == 1 else w.shape[0]
        es = tbp._weights_es(w, b, nv, S)
        assert es.shape == (b * nv, S) and es.is_contiguous(), w.shape
        want = (w[None, :, None].expand(b, nv, S) if w.dim() == 1 else
                w[:, :, None].expand(b, nv, S) if w.dim() == 2 else
                w.transpose(1, 2))
        assert torch.equal(es, want.reshape(b * nv, S))


def test_quantized_head_is_contiguous_at_any_vocabulary():
    """--int8's tied head is quantize_weight(wte.T): with a vocabulary that
    needs no padding to 128 (backpack-test's 512) the transposed view's
    strides must not reach the codes and scales K2 reads; the values are
    those of the contiguous weight's quantization."""
    from backpacks_flash_attn_tpu_torch.ops import quant
    wte = torch.randn(512, 64, generator=torch.Generator().manual_seed(0))
    for bits, gs in ((8, None), (4, 32)):
        qw = quant.quantize_weight(wte.T, bits, gs)
        assert qw.q.is_contiguous() and qw.scale.is_contiguous(), bits
        ref = quant.quantize_weight(wte.T.contiguous(), bits, gs)
        assert torch.equal(qw.q, ref.q) and torch.equal(qw.scale, ref.scale)
