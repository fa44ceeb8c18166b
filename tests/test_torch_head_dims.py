"""Head dims past 64 in the port's flash attention (K3, K5) and block-sparse
attention (K9) against the JAX package's, on the CPU in f32.

JAX's kernels compute any head dim (``_head_pad`` pads it to 128); the
port's kernels are built for 64, 80, 96 and 128 and pad any other head dim
up to 128 to the next of them (``ops/flash_attention.py``
``head_dim_instance``, ``pad_heads``, ``cut_heads``). On the CPU the port
takes its plain versions, so these tests hold those to JAX's kernels (run
as JAX's own tests run them: Pallas in interpret mode), at the head dims
of the repo's configurations: backpack-mini's and gpt3-2.7b's 80,
gpt3-large's 96 and gpt3-xl's 128. Then the padding against the unpadded
plain versions, the instance rule and the kernels' shared memory, the C
sources' list of instances, a tiny Backpack with heads of 80 (forward and
three AdamW steps) and a tiny rotary GPT with heads of 128 (forward and
gradients). Tolerances: 1e-5 on
attention and its gradients (f32 sums in another order), 1e-4 on logits
and gradients of whole models, rtol 1e-4 on training steps (atol 1e-6 for
the elements whose true gradient is 0, as tests/test_torch_train.py).
"""

import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from backpacks_flash_attn_tpu import config as jcfg
from backpacks_flash_attn_tpu.models import backpack as jbp
from backpacks_flash_attn_tpu.models import gpt as jgpt
from backpacks_flash_attn_tpu.ops import flash_attention as jfa
from backpacks_flash_attn_tpu.training import train as jtrain
from backpacks_flash_attn_tpu_torch import config as tcfg
from backpacks_flash_attn_tpu_torch.models import backpack as tbp
from backpacks_flash_attn_tpu_torch.models import gpt as tgpt
from backpacks_flash_attn_tpu_torch.ops import flash_attention as tfa
from backpacks_flash_attn_tpu_torch.training import train as ttrain
from backpacks_flash_attn_tpu_torch.utils import prng
from backpacks_flash_attn_tpu_torch.utils.weights import (params_from_numpy,
                                                         params_to_numpy)

torch.set_num_threads(1)

ATOL = 1e-5
SMEM_BLOCK = 232448      # an H100 block's shared memory (227 KB)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("d", [80, 96, 128])
def test_flash_attention_ref_matches_jax_at_head_dims(d):
    """K3's plain version against JAX's ``_flash_fwd`` at head dim d, in one
    call with everything on: causal, ragged lengths (one sequence empty),
    per-sequence query offsets, sq != sk, dropout 0.2. Out and LSE."""
    rng = np.random.default_rng(d)
    b, sq, sk, h = 3, 24, 40, 2
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, sk, h, d)).astype(np.float32) for _ in range(2))
    lens = np.array([40, 0, 29], np.int32)
    offs = np.array([16, 0, 5], np.int32)
    scale, p = d ** -0.5, 0.2
    seed = jax.random.key_data(jax.random.PRNGKey(7)).astype(jnp.uint32)
    sw = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)
    jout, jlse = jfa._flash_fwd(sw(q), sw(k), sw(v), jnp.asarray(lens), scale, True,
                                256, 256, dropout_p=p, seed=seed,
                                q_offsets=jnp.asarray(offs))
    out, lse = tfa.flash_attention_ref(
        _t(q), _t(k), _t(v), causal=True, softmax_scale=scale, seq_lengths=_t(lens),
        q_offsets=_t(offs), dropout_p=p, seed=prng.seed_words(prng.PRNGKey(7)),
        return_lse=True)
    np.testing.assert_allclose(_np(out), np.swapaxes(np.asarray(jout), 1, 2), atol=ATOL)
    np.testing.assert_allclose(_np(lse), np.asarray(jlse), atol=ATOL, rtol=1e-6)
    assert (_np(out)[1] == 0).all() and (_np(lse)[1] == tfa.NEG_INF).all()


@pytest.mark.parametrize("d", [80, 96, 128])
def test_flash_attention_grads_match_jax_at_head_dims(d):
    """K5's plain version (the port's autograd Function on the CPU) against
    JAX's custom_vjp (``_flash_bwd``'s Pallas bodies) at head dim d, causal,
    dropout 0.1: out and the q, k, v gradients."""
    rng = np.random.default_rng(100 + d)
    b, s, h = 2, 40, 2
    q, k, v, g = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(4))
    kw = dict(causal=True, softmax_scale=d ** -0.5, dropout_p=0.1)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, dropout_rng=jax.random.PRNGKey(5), **kw)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    tout = tfa.flash_attention(tq, tk, tv, dropout_rng=prng.PRNGKey(5), **kw)
    (tout * _t(g)).sum().backward()
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=ATOL)
    for name, jgr, t in zip("qkv", jgrads, (tq, tk, tv)):
        np.testing.assert_allclose(_np(t.grad), np.asarray(jgr), atol=ATOL,
                                   err_msg=f"d{name}")


def test_blocksparse_fwd_and_grads_match_jax_at_head_dim_96():
    """The block-sparse op at gpt3-large's head dim against JAX's
    ``flash_blocksparse_attention`` (custom_vjp, Pallas in interpret mode):
    causal, a random mask over 128 x 128 blocks with query block 1 empty;
    out and the q, k, v gradients."""
    rng = np.random.default_rng(96)
    b, s, h, d, block = 2, 384, 2, 96, 128
    q, k, v, g = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(4))
    bm = (rng.random((3, 3)) < 0.7).astype(np.int32)
    bm[:, 0] = 1
    bm[1] = 0
    kw = dict(causal=True, block_q=block, block_k=block)

    def jloss(q, k, v):
        o = jfa.flash_blocksparse_attention(q, k, v, jnp.asarray(bm), **kw)
        return jnp.sum(o * g), o

    (_, jo), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    to = tfa.flash_blocksparse_attention(tq, tk, tv, _t(bm), **kw)
    (to * _t(g)).sum().backward()
    assert (to[:, block:2 * block] == 0).all()
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=ATOL, rtol=0)
    for name, a, want in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(want), atol=ATOL, rtol=0,
                                   err_msg=f"d{name}")


def test_padded_head_dims_equal_the_unpadded_plain_versions():
    """At d 48 and 112 (padded to the 64 and 128 instances): the plain
    versions over the zero-padded operands, cut back with ``cut_heads``,
    equal the plain versions over the operands themselves (forward, LSE,
    dq, dk, dv; the block-sparse forward and backward too) at the true
    d's scale (within 1e-5: the products sum over other widths), and every
    padded output column is exactly 0."""
    rng = np.random.default_rng(48)
    b, s, h = 2, 33, 2
    for d, inst in ((48, 64), (112, 128)):
        assert tfa.head_dim_instance(d) == inst
        q, k, v, g = (_t(rng.normal(size=(b, s, h, d)).astype(np.float32))
                      for _ in range(4))
        padded = tfa.pad_heads(inst, q, k, v, g)
        assert all(x.shape[-1] == inst and (x[..., d:] == 0).all() for x in padded)
        assert tfa.pad_heads(d, q)[0] is q and tfa.cut_heads(d, q)[0] is q
        kw = dict(causal=True, softmax_scale=d ** -0.5, dropout_p=0.1, seed=(3, 4))
        out, lse = tfa.flash_attention_ref(q, k, v, return_lse=True, **kw)
        pout, plse = tfa.flash_attention_ref(*padded[:3], return_lse=True, **kw)
        assert (pout[..., d:] == 0).all()
        np.testing.assert_allclose(_np(tfa.cut_heads(d, pout)[0]), _np(out), atol=ATOL)
        np.testing.assert_allclose(_np(plse), _np(lse), atol=ATOL)
        grads = tfa.flash_attention_bwd_ref(q, k, v, out, lse, g, **kw)
        pgrads = tfa.flash_attention_bwd_ref(*padded[:3], pout, plse, padded[3], **kw)
        for name, a, want in zip("qkv", tfa.cut_heads(d, *pgrads), grads):
            assert a.is_contiguous()
            np.testing.assert_allclose(_np(a), _np(want), atol=ATOL, err_msg=f"{d} d{name}")
        assert all((x[..., d:] == 0).all() for x in pgrads)
        act = tfa.blocksparse_active(torch.ones(1, 1, dtype=torch.int32), True, 64, 64)
        bkw = dict(causal=True, block_q=64, block_k=64)
        qs = q * d ** -0.5
        bout, blse = tfa.blocksparse_attention_ref(qs, k, v, act, **bkw)
        pbout, pblse = tfa.blocksparse_attention_ref(*tfa.pad_heads(inst, qs, k, v), act,
                                                     **bkw)
        np.testing.assert_allclose(_np(tfa.cut_heads(d, pbout)[0]), _np(bout), atol=ATOL)
        np.testing.assert_allclose(_np(pblse), _np(blse), atol=ATOL)
        bgrads = tfa.blocksparse_attention_bwd_ref(qs, k, v, bout, blse, g, act, **bkw)
        pbgrads = tfa.blocksparse_attention_bwd_ref(*tfa.pad_heads(inst, qs, k, v), pbout,
                                                    pblse, padded[3], act, **bkw)
        for a, want in zip(tfa.cut_heads(d, *pbgrads), bgrads):
            np.testing.assert_allclose(_np(a), _np(want), atol=ATOL, err_msg=str(d))


def _k3_smem(rows, d):
    """K3's block (csrc/flash_attention.cuh launch_form): Q rows and a
    2-stage ring of 64-key K and V tiles, rows of d + 8 bf16."""
    return 2 * (rows + 2 * 2 * 64) * (d + 8)


def _k5_smem(key_tile, d):
    """K5's main kernel (csrc/flash_attention_bwd.cuh bwd_smem_bytes): K
    (and V past d 64) in rows of d + 8 bf16, two dS^T buffers of 72-bf16
    rows, a 2-stage ring of Q, dO (64 rows of d + 8) and the LSE and delta
    (64 f32 each)."""
    kv = 2 if d > 64 else 1
    return 2 * (kv * key_tile * (d + 8) + 2 * key_tile * 72) + 2 * (2 * 64 * (d + 8) * 2 + 512)


def test_head_dim_instances_and_their_tiles():
    """Every head dim up to 128 takes the least instance at or above it,
    the repo's configurations' head dims are instances (no padding), and
    wider heads raise naming ROADMAP Queue 2 item 2. At every instance and
    sequence length the tiles the wrappers pick fit a block's shared
    memory: K3's 32/64-row tiles (128 only at d 64), K5's and K9's key
    tiles (128 past d 64), and the ptxas limits they were built for (K3
    at d 128 holds 2 blocks of 4 warps an SM)."""
    for d in range(1, 129):
        inst = tfa.head_dim_instance(d)
        assert inst in tfa.HEAD_DIMS and inst >= d, d
        assert all(i < d for i in tfa.HEAD_DIMS if i < inst), d
    for make in (tcfg.backpack_mini, tcfg.backpack_small, tcfg.gpt3_small, tcfg.gpt3_large,
                 tcfg.gpt3_xl, tcfg.gpt3_2_7b):
        cfg = make()
        assert tfa.head_dim_instance(cfg.n_embd // cfg.n_head) == cfg.n_embd // cfg.n_head
    for d in (129, 160, 192, 256):
        with pytest.raises(ValueError, match="ROADMAP Queue 2 item 2"):
            tfa.head_dim_instance(d)
    for inst in tfa.HEAD_DIMS:
        for s in (1, 32, 33, 512, 1024, 1025, 2048, 8192):
            rows = tfa._k9_rows(s, 256, inst)
            assert rows in ((32, 64, 128) if inst == 64 else (32, 64)), (inst, s)
            assert _k3_smem(rows, inst) <= SMEM_BLOCK, (inst, s)
            tile = tfa._k5_key_tile(s, inst)
            assert tile == (128 if s <= 1024 or inst > 64 else 64), (inst, s)
            assert _k5_smem(tile, inst) <= SMEM_BLOCK, (inst, s)
            assert _k5_smem(64, inst) <= SMEM_BLOCK, inst        # K9 at 64-key blocks
        assert 2 * (_k3_smem(64, inst) + 1024) <= 233472, inst


def test_c_head_dim_instances_are_the_python_list():
    """The C entries of K3, K5 and K9 reach their head-dim instances
    through one dispatch, common.cuh's with_head_dim, whose cases are
    exactly HEAD_DIMS (each case's d its D); no attention source switches
    on d itself."""
    csrc = Path(tfa.__file__).resolve().parents[1] / "csrc"
    src = (csrc / "common.cuh").read_text()
    body = src[src.index("auto with_head_dim("):]
    body = body[:body.index("\n}\n")]
    cases = re.findall(r"case (\d+): return f\(std::integral_constant<int, (\d+)>\{\}\);", body)
    assert all(d == inst for d, inst in cases), cases
    assert tuple(int(d) for d, _ in cases) == tfa.HEAD_DIMS
    for name in ("flash_attention.cu", "flash_attention.cuh", "flash_attention_bwd.cu",
                 "flash_attention_bwd.cuh", "blocksparse_attention.cu",
                 "blocksparse_attention_bwd.cu"):
        text = (csrc / name).read_text()
        assert "switch (d)" not in text, name
        if name.endswith(".cu"):
            assert "with_head_dim(d, " in text, name


def _backpack_pair():
    """A tiny Backpack with heads of 80 (backpack-mini's): 2 layers, width
    160, 2 heads, 4 senses of 40."""
    kw = dict(vocab_size=512, n_positions=64, n_embd=160, n_head=2, n_layer=2,
              num_senses=4, scale_attn_by_inverse_layer_idx=True,
              pad_vocab_size_multiple=8)
    return jcfg.BackpackConfig(**kw), tcfg.BackpackConfig(**kw)


def test_backpack_heads_of_80_forward_and_train_steps_match_jax():
    """The tiny Backpack's logits, then three AdamW steps from the same
    weights and key (dropout on): loss, gradient norm and every updated
    parameter after each step."""
    jc, tc = _backpack_pair()
    assert tc.n_embd // tc.n_head == 80
    jparams = jbp.init_backpack(jc, jax.random.PRNGKey(0))
    tparams = ttrain.trainable(params_from_numpy(jax.tree.map(np.asarray, jparams),
                                                 device="cpu"))
    ids = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 17)).astype(np.int32)
    jl = jax.jit(lambda p, x: jbp.backpack_forward(p, jc, x))(jparams, ids)
    with torch.no_grad():
        tl = tbp.backpack_forward(tparams, tc, _t(ids).long())
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-4, rtol=0)

    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    tx = jtrain.make_optimizer(jparams, **opt)
    jstate = jtrain.TrainState(jparams, tx.init(jparams), jnp.zeros((), jnp.int32))
    jstep = jax.jit(jtrain.make_train_step(jc, tx))
    tstate = ttrain.TrainState(tparams, ttrain.make_optimizer(tparams, **opt), 0)
    tstep = ttrain.make_train_step(tc)
    for _ in range(3):
        jstate, jm = jstep(jstate, {"input_ids": jnp.asarray(ids)}, jax.random.PRNGKey(1))
        tstate, tm = tstep(tstate, {"input_ids": _t(ids).long()}, prng.PRNGKey(1))
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[name].item(), float(jm[name]), rtol=1e-4,
                                       err_msg=name)
        want = dict(ttrain.named_leaves(jax.tree.map(np.asarray, jstate.params)))
        got = dict(ttrain.named_leaves(params_to_numpy(tstate.params)))
        assert want.keys() == got.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg="/".join(k))


def test_rotary_gpt_heads_of_128_forward_and_grads_match_jax():
    """A tiny rotary GPT with heads of 128 (gpt3-xl's; 64 rotated channels
    a head, no learned positions): logits, then the loss's gradients of
    every parameter with dropout on."""
    kw = dict(vocab_size=512, n_positions=0, n_embd=256, n_head=2, n_layer=2,
              rotary_emb_fraction=0.5)
    jc, tc = jcfg.GPTConfig(**kw), tcfg.GPTConfig(**kw)
    assert tc.head_dim == 128 and tc.rotary_emb_dim == 64
    jparams = jgpt.init_gpt(jc, jax.random.PRNGKey(3))
    tparams = ttrain.trainable(params_from_numpy(jax.tree.map(np.asarray, jparams),
                                                 device="cpu"))
    ids = np.random.default_rng(3).integers(0, 512, (2, 33)).astype(np.int32)
    jl = jax.jit(lambda p, x: jgpt.gpt_lm_forward(p, jc, x))(jparams, ids)
    with torch.no_grad():
        tl = tgpt.gpt_lm_forward(tparams, tc, _t(ids).long())
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-4, rtol=0)

    def jloss(p):
        logits = jgpt.gpt_lm_forward(p, jc, ids, train=True, rng=jax.random.PRNGKey(1))
        return jnp.mean(jax.nn.logsumexp(logits, -1)
                        - jnp.take_along_axis(logits, ids[..., None], -1)[..., 0])

    jgrads = jax.jit(jax.grad(jloss))(jparams)
    logits = tgpt.gpt_lm_forward(tparams, tc, _t(ids).long(), train=True,
                                 rng=prng.PRNGKey(1))
    loss = (torch.logsumexp(logits, -1)
            - logits.gather(-1, _t(ids).long()[..., None])[..., 0]).mean()
    loss.backward()
    want = dict(ttrain.named_leaves(jax.tree.map(np.asarray, jgrads)))
    got = {k: _np(t.grad) for k, t in ttrain.named_leaves(tparams)}
    assert want.keys() == got.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-4, rtol=1e-4, err_msg="/".join(k))
