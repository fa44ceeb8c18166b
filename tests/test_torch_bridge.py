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
from backpacks_flash_attn_tpu_torch.eval import perplexity, quant_gates
from backpacks_flash_attn_tpu_torch.serving.engine import ServingEngine
from backpacks_flash_attn_tpu_torch.training import train_cli
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
    """Statically: no import of jax or of the JAX package in the port,
    chip_smoke.py, chip_gate_sweep.py or bench_quant_matmul.py. Dynamically: with both blocked,
    the port imports and runs a tiny CPU forward, a cached decode step, a
    decode step over the low-bit (4, None) caches, the quant-gates module,
    a training step, the serving engine over a staged cache (its C++
    scheduler built), a rotary GPT training step with the fused-MLP switch
    on, generate_gpt, the block-sparse op, K1's three redesigns, the
    intervention evals' modules, a negative-weighted step under an
    all-ones table (the plain logits), the tokenizers, the REPL on an
    imported checkpoint, a PPLM generation, MAUVE's features and the other
    modules of the entry-point slice, the context-parallel modules
    (the ring pair functions on the CPU), the tensor-parallel serving
    modules (the permute, the spec tree, the TP cache's round trip), and
    the encoders' slice (a tiny
    BERT forward over a padded batch and pretraining loss, a ViT forward,
    flash attention with a score bias and its gradient, the softmax and
    padding modules). The ranks' module of the
    parallel tests (tests/torch_parallel_ranks.py) is held JAX-free too."""
    pattern = re.compile(r"^\s*(import|from) +(jax|backpacks_flash_attn_tpu)\b",
                         re.M)
    for path in [*PORT.rglob("*.py"), REPO / "chip_smoke.py",
                 REPO / "chip_gate_sweep.py", REPO / "bench_quant_matmul.py",
                 REPO / "tests" / "torch_parallel_ranks.py"]:
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
from backpacks_flash_attn_tpu_torch.eval import quant_gates
cache4 = bp.init_backpack_cache(cfg, 2, 16, torch.int8, device="cpu", bits=4)
assert (cache4.bits, cache4.gpt.bits) == (4, 4)
_, cache4 = bp.backpack_forward_with_cache(params, cfg, ids, cache4)
low, cache4 = bp.backpack_forward_with_cache(params, cfg, ids[:, :1], cache4)
assert cache4.length == 7 and torch.isfinite(low).all()
from backpacks_flash_attn_tpu_torch.training import train, train_cli
from backpacks_flash_attn_tpu_torch.utils import prng
tp = train.trainable(params)
state = train.TrainState(tp, train.make_optimizer(tp, warmup_steps=1), 0)
step_fn = train.make_train_step(cfg, fused_ctx=True)
batch = {"input_ids": torch.randint(0, cfg.vocab_size, (2, 9))}
state, metrics = step_fn(state, batch, prng.PRNGKey(0))
assert state.step == 1 and torch.isfinite(metrics["loss"])
from backpacks_flash_attn_tpu_torch.serving.engine import ServingEngine
eng = ServingEngine(params, cfg, max_slots=2, max_seqlen=32, eos_id=-1,
                    cache_dtype=torch.int8, stage_tokens=4, device="cpu")
outs = eng.generate([[1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11, 12]],
                    max_new_tokens=6)
assert [len(o) for o in outs] == [6, 6] and eng.stats()["flushes"] >= 1
from backpacks_flash_attn_tpu_torch.config import GPTConfig
from backpacks_flash_attn_tpu_torch.models import gpt
from backpacks_flash_attn_tpu_torch.ops import dense, flash_attention as fa
from backpacks_flash_attn_tpu_torch.utils.generation import generate_gpt
dense._FUSED_MLP = True
gcfg = GPTConfig(vocab_size=512, n_positions=0, n_embd=128, n_head=2,
                 n_layer=2, rotary_emb_fraction=0.5)
gp = train.trainable(gpt.init_gpt(gcfg, torch.Generator().manual_seed(0),
                                  device="cpu"))
gstate = train.TrainState(gp, train.make_optimizer(gp, warmup_steps=1), 0)
gstate, gm = train.make_train_step(gcfg, model="gpt")(gstate, batch,
                                                      prng.PRNGKey(0))
assert torch.isfinite(gm["loss"])
seq = generate_gpt(gp, gcfg, ids, 10, device="cpu").sequences
assert seq.shape == (2, 10)
x = torch.randn(1, 256, 2, 16)
bso = fa.flash_blocksparse_attention(x, x, x, torch.ones(2, 2), block_q=128,
                                     block_k=128)
assert torch.isfinite(bso).all()
from backpacks_flash_attn_tpu_torch.ops import decode_attention as da
dq, dkt, dv = torch.randn(4, 8), torch.randn(4, 8, 40), torch.randn(4, 40, 16)
for fn in (da.decode_attention_gathered, da.decode_attention_selector,
           da.decode_attention_blockdiag):
    assert fn(dq, dkt, None, dv, None, 33).shape == (4, 16)
from backpacks_flash_attn_tpu_torch.eval import control, genderbias, similarity
from backpacks_flash_attn_tpu_torch.eval import toxicity, visualize
from backpacks_flash_attn_tpu_torch.models import interventions as iv
ones = torch.ones(cfg.padded_vocab_size, cfg.num_senses)
nst = iv.init_negative_decode_state(cfg, 2, 16, device="cpu")
neg, _, _ = iv.negative_decode_step(
    params, cfg, ids, bp.init_backpack_cache(cfg, 2, 16, torch.float32,
                                             device="cpu"), nst, ones)
assert torch.allclose(neg, logits, atol=1e-5), (neg - logits).abs().max()
import io, tempfile
from backpacks_flash_attn_tpu_torch import cli
from backpacks_flash_attn_tpu_torch.data import prepare
from backpacks_flash_attn_tpu_torch.eval import lm_harness, mauve, plots, pplm
from backpacks_flash_attn_tpu_torch.utils import fast_tokenizer, pretrained
from backpacks_flash_attn_tpu_torch.utils import tokenizer, torch_import
tok = fast_tokenizer.FastGPT2Tokenizer(
    tokenizer.GPT2Tokenizer.train_toy(["a b ab abc"] * 3, vocab_size=300))
assert tok.decode(tok.encode(" ab abc")) == " ab abc"
with tempfile.TemporaryDirectory() as d:
    torch.save({"state_dict": {"model." + k: torch.from_numpy(v) for k, v in
                               torch_import.state_dict_from_backpack_params(
                                   params, cfg).items()}}, d + "/w.ckpt")
    sys.stdin = io.StringIO("1 2 3\\n/senses 4\\n")
    cli.main(["--checkpoint", d + "/w.ckpt", "--model", "backpack-test",
              "--device", "cpu", "--max-new-tokens", "2"])
gp32 = gpt.init_gpt(gcfg, torch.Generator().manual_seed(1), device="cpu")
assert pplm.pplm_generate(gp32, gcfg, ids[:, :4], [5, 6],
                          max_new_tokens=2).shape == (2, 2)
feats = mauve.featurize_terminal_hidden(params, cfg, [[1, 2], [3]],
                                        model="backpack", batch_size=2)
assert feats.shape == (2, cfg.n_embd)
from backpacks_flash_attn_tpu_torch.parallel import cp_train, launch, mesh
from backpacks_flash_attn_tpu_torch.parallel import ring_attention
qh = torch.randn(1, 2, 8, 16)
o, l = fa.flash_fwd(qh, qh, qh, None, 0.25, True, q_offsets=8, k_offsets=0)
assert fa.flash_bwd(qh, qh, qh, o, l, o, None, 0.25, True, q_offsets=8,
                    k_offsets=0)[0].shape == qh.shape
assert ring_attention.zigzag_order(8, 2).tolist() == [0, 1, 6, 7, 2, 3, 4, 5]
from backpacks_flash_attn_tpu_torch.parallel import serving, tp_decode
perm = tp_decode.permute_for_tp_decode(params, cfg)
assert perm["gpt"]["layers"]["Wqkv"]["kernel"].shape == (2, 64, 192)
assert mesh.param_specs(params, cfg)["gpt"]["wte"] == ("model", None)
tpc = tp_decode.to_tp_cache(cache, cfg)
assert tpc.k.shape == (2, 2, 4, 16, 16) and tpc.length == 6
assert tp_decode.from_tp_cache(tpc, cfg).content.shape == cache.content.shape
from backpacks_flash_attn_tpu_torch.models import bert, vit
from backpacks_flash_attn_tpu_torch.ops import softmax
from backpacks_flash_attn_tpu_torch.utils import padding
bcfg = bert.bert_test()
bpar = bert.init_bert(bcfg, torch.Generator().manual_seed(0), device="cpu")
bids = torch.randint(0, bcfg.vocab_size, (2, 8))
bmask = torch.arange(8)[None, :] < torch.tensor([[8], [5]])
seq_out, pooled = bert.bert_forward(bpar, bcfg, bids, attention_mask=bmask)
assert seq_out.shape == (2, 8, 64) and pooled.shape == (2, 64)
pre = bert.bert_for_pretraining(bpar, bcfg, bids, labels=bids,
                                next_sentence_label=torch.tensor([0, 1]))
assert torch.isfinite(pre.loss)
vcfg = vit.vit_test()
vpar = vit.init_vit(vcfg, torch.Generator().manual_seed(0), device="cpu")
assert vit.vit_forward(vpar, vcfg, torch.randn(2, 3, 16, 16)).shape == (2, 10)
bias = torch.randn(2, 1, 8, 8, requires_grad=True)
xb = torch.randn(2, 8, 2, 16, requires_grad=True)
fa.flash_attention(xb, xb, xb, causal=False, attn_bias=bias).sum().backward()
assert bias.grad.shape == bias.shape and xb.grad.shape == xb.shape
assert softmax.FusedScaleMaskSoftmax(causal=True)(torch.randn(1, 1, 3, 3)).shape == (1, 1, 3, 3)
assert padding.unpad_input(torch.randn(2, 8, 4), bmask).values.shape == (16, 4)
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
        lambda: tbp.init_backpack_cache(cfg, 1, 8, torch.int8, bits=4),
        lambda: quant_gates.run_cache_gates(params, cfg,
                                            np.zeros(64, np.uint16), 8),
        lambda: params_from_numpy(np_tree),
        lambda: tgen.generate_backpack(params, cfg, ids, 6),
        lambda: tgen.generate_gpt(params["gpt"], cfg, ids, 6),
        lambda: ServingEngine(params, cfg),
        lambda: tbp.init_backpack_cache(cfg, 1, 8, per_slot=True, stage=4),
        lambda: train_cli.run(train_cli.RunConfig(corpus="unused.npy")),
        lambda: perplexity.evaluate_perplexity(
            lambda x: x, np.zeros(64, np.uint16), 8, 2),
        lambda: cli.main(["--model", "backpack-test"]),
        lambda: torch_import.backpack_params_from_state_dict(
            torch_import.state_dict_from_backpack_params(params, cfg), cfg),
    ]
    from backpacks_flash_attn_tpu_torch import cli
    from backpacks_flash_attn_tpu_torch.utils import torch_import
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
    o, lse = tfa.flash_attention_ref(a, a, a, return_lse=True)
    assert all(torch.equal(x, y) for x, y in zip(
        tfa.flash_attention_bwd(a, a, a, o, lse, a),
        tfa.flash_attention_bwd_ref(a, a, a, o, lse, a)))
    _, clse = tbk.contextualization_reference(qc, kc, cc, 0.5, return_lse=True)
    g = r(2, 6, 8)
    assert all(torch.equal(x, y) for x, y in zip(
        tbk.fused_ctx_bwd(qc, kc, cc, clse, g, 0.5),
        tbk.fused_ctx_bwd_ref(qc, kc, cc, clse, g, 0.5)))
    lens = torch.tensor([0, 3, 10, 7])
    assert all(torch.equal(x, y) for x, y in zip(
        tda.decode_attention_ml(q, kt, None, v, None, lens),
        tda.decode_attention_ml_ref(q, kt, None, v, None, lens)))
    k4 = torch.randint(-128, 128, (4, 8, 5), dtype=torch.int8)
    v4 = torch.randint(-128, 128, (4, 5, 16), dtype=torch.int8)
    sc = torch.rand(4, 2, 5)
    assert all(torch.equal(x, y) for x, y in zip(
        tda.decode_attention_int4_ml(q, k4, sc, v4, sc, lens),
        tda.decode_attention_flat_int4_ml(q, k4, sc, v4, sc, lens)))
    from backpacks_flash_attn_tpu_torch.ops import fused_mlp as tfm
    g2 = torch.Generator().manual_seed(1)
    x, w1, w2, b1, b2 = (torch.randn(*s, generator=g2)
                         for s in ((5, 8), (8, 16), (16, 8), (16,), (8,)))
    assert all(torch.equal(u, w) for u, w in zip(
        tfm.mlp_fwd_fused(x, w1, b1, w2, b2),
        tfm.mlp_fwd_fused_ref(x, w1, b1, w2, b2)))
    act = tfa.blocksparse_active(torch.tensor([[1, 0], [1, 1]]), True, 4, 4)
    assert torch.equal(
        tfa.flash_blocksparse_attention(a, a, a, torch.tensor([[1, 0], [1, 1]]),
                                        block_q=4, block_k=4),
        tfa.blocksparse_attention_ref((a.float() * 0.25).to(a.dtype), a, a,
                                      act, causal=True, block_q=4,
                                      block_k=4)[0])
    bias = torch.randn(1, 2, 5, 7, generator=torch.Generator().manual_seed(2))
    assert torch.equal(
        tfa.flash_attention(a, b, c, attn_bias=bias),
        tfa.flash_attention_ref(a, b, c, attn_bias=bias))
    assert _build.launch_counts() == {k: 0 for k in _build.KERNELS}


def test_kernel_operand_copies_unaligned_contiguous_views():
    """A bf16 view one element into its storage is contiguous but its rows
    are not 16-byte aligned: kernel_operand hands the backward kernels a
    fresh aligned copy (``contiguous()`` returned the view itself, and K5's
    16-byte copies faulted on it); aligned and f32 operands pass through,
    and a cotangent expanded along its last dim (stride 0) is copied."""
    store = torch.randn(2 * 5 * 64 + 1).to(torch.bfloat16)
    view = store[1:].view(2, 5, 64)
    assert view.is_contiguous() and not _build.aligned16(view)
    op = _build.kernel_operand(view)
    assert _build.aligned16(op) and op.data_ptr() != view.data_ptr()
    assert torch.equal(op, view)
    aligned = torch.randn(2, 5, 64).to(torch.bfloat16)
    assert _build.kernel_operand(aligned) is aligned
    f32 = torch.randn(2 * 5 * 64 + 1)[1:].view(2, 5, 64)
    assert _build.kernel_operand(f32) is f32
    expanded = torch.randn(2, 5, 1).expand(2, 5, 64)
    assert _build.kernel_operand(expanded).stride() == (320, 64, 1)


def test_plain_path_switch_is_scoped():
    assert _build.kernels_enabled()
    with _build.plain_path():
        assert not _build.kernels_enabled()
    assert _build.kernels_enabled()


def test_launch_runs_on_the_tensors_device(monkeypatch):
    """A kernel launch whose operands lie on a device other than the
    current one enters that device's guard and takes that device's stream;
    operands on the current device (or none) take no guard. The CUDA
    queries are stubbed: only the index the launch path picks is checked."""
    import contextlib
    import types

    calls = []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda i: calls.append(("stream", i)) or 1000 + i,
                        raising=False)

    @contextlib.contextmanager
    def guard(i):
        calls.append(("enter", i))
        yield
        calls.append(("exit", i))

    monkeypatch.setattr(torch.cuda, "device", guard)

    class Entry:
        argtypes = None

        def __call__(self, *args):
            calls.append(("launch", args[-1]))
            return 0

    lib = types.SimpleNamespace(entry=Entry(), kernel_error_string=None)
    kernel = _build.Kernel("stub", "stub.cu", "", lib=lib)

    def tensor(index):
        return types.SimpleNamespace(data_ptr=lambda: 4096,
                                     device=torch.device("cuda", index))

    for index, want in ((1, [("enter", 1), ("stream", 1), ("launch", 1001),
                             ("exit", 1)]),
                        (0, [("stream", 0), ("launch", 1000)])):
        calls.clear()
        _build.launch(kernel, "entry", _build.Ptr.of(None),
                      _build.Ptr.of(tensor(index)), 3, 0.5)
        assert calls == want, (index, calls)
    calls.clear()
    _build.launch(kernel, "entry", 3)
    assert calls == [("stream", 0), ("launch", 1000)]
    assert kernel.launches == 3
    assert _build.Ptr.of(torch.zeros(2)).device is None     # a CPU tensor


def test_backpack_module_matches_functions(jax_params):
    cfg = tcfg.backpack_test()
    params = params_from_numpy(jax.tree.map(np.asarray, jax_params),
                               device="cpu")
    model = tbp.BackpackLM(cfg, params)
    ids = torch.randint(0, cfg.vocab_size, (2, 5),
                        generator=torch.Generator().manual_seed(1))
    assert torch.equal(model(ids), tbp.backpack_forward(params, cfg, ids))
    assert "gpt__layers__Wqkv__kernel" in dict(model.named_parameters())
    qmodel = model.quantized(bits=8)
    assert isinstance(qmodel.params["gpt"]["lm_head"], tq.QuantWeight)
    cache = qmodel.init_cache(2, 16, torch.int8)
    logits, cache = qmodel.step(ids, cache)
    assert logits.dtype == torch.float32 and cache.length == 5
    assert torch.isfinite(logits).all()
