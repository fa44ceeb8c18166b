"""The PyTorch port's ops against the JAX package's, on the CPU in f32.

Each kernel's plain version (what a CPU tensor takes) is held against the
JAX function it ports, run as the JAX package's own tests run it: the
Pallas kernels in interpret mode on the CPU. The same numpy-seeded inputs go
through both. Tolerances: 1e-5 for the elementwise ops, 5e-5 for attention
(f32 sums taken in another order), exact for quantization codes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu.ops import attention as jatt
from backpacks_flash_attn_tpu.ops import backpack_kernels as jbk
from backpacks_flash_attn_tpu.ops import decode_attention as jda
from backpacks_flash_attn_tpu.ops import dense as jdense
from backpacks_flash_attn_tpu.ops import flash_attention as jfa
from backpacks_flash_attn_tpu.ops import norms as jnorms
from backpacks_flash_attn_tpu.ops import quant as jq
from backpacks_flash_attn_tpu_torch.ops import attention as tatt
from backpacks_flash_attn_tpu_torch.ops import backpack_kernels as tbk
from backpacks_flash_attn_tpu_torch.ops import decode_attention as tda
from backpacks_flash_attn_tpu_torch.ops import dense as tdense
from backpacks_flash_attn_tpu_torch.ops import flash_attention as tfa
from backpacks_flash_attn_tpu_torch.ops import norms as tnorms
from backpacks_flash_attn_tpu_torch.ops import quant as tq
from backpacks_flash_attn_tpu_torch.utils.weights import params_from_numpy

torch.set_num_threads(1)

ATOL_ELEMENTWISE = 1e-5
ATOL_ATTENTION = 5e-5


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _decode_inputs(rng, cache):
    E, dk, S, dv = 8, 16, 24, 32
    q = rng.normal(size=(E, dk)).astype(np.float32) * 0.3
    if cache == "int8":
        kt = rng.integers(-127, 128, (E, dk, S)).astype(np.int8)
        v = rng.integers(-127, 128, (E, S, dv)).astype(np.int8)
        ks = rng.uniform(0.002, 0.02, (E, S)).astype(np.float32)
        vs = rng.uniform(0.002, 0.02, (E, S)).astype(np.float32)
    else:
        kt = rng.normal(size=(E, dk, S)).astype(np.float32)
        v = rng.normal(size=(E, S, dv)).astype(np.float32)
        ks = vs = None
    # ragged per-row lengths, including an empty row and a full one
    length = np.array([0, 1, 5, 11, 17, 23, 24, 9], np.int32)
    return q, kt, ks, v, vs, length


@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
def test_decode_attention_matches_jax(rng, cache):
    q, kt, ks, v, vs, length = _decode_inputs(rng, cache)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}.get(cache)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(cache)
    jkt, jv = (jnp.asarray(kt), jnp.asarray(v)) if jdt is None else \
        (jnp.asarray(kt, jdt), jnp.asarray(v, jdt))
    tkt, tv = (_t(kt), _t(v)) if tdt is None else (_t(kt).to(tdt), _t(v).to(tdt))
    jks = None if ks is None else jnp.asarray(ks)
    jvs = None if vs is None else jnp.asarray(vs)
    tks = None if ks is None else _t(ks)
    tvs = None if vs is None else _t(vs)
    out = tda.decode_attention(_t(q), tkt, tks, tv, tvs, _t(length))
    fused = jda.decode_attention_fused(jnp.asarray(q), jkt, jks, jv, jvs,
                                       jnp.asarray(length))
    flat = jda.decode_attention_flat(jnp.asarray(q), jkt, jks, jv, jvs,
                                     jnp.asarray(length))
    assert out.dtype == torch.float32 and out.shape == (8, 32)
    np.testing.assert_allclose(_np(out), _np(fused), atol=ATOL_ATTENTION,
                               rtol=0)
    np.testing.assert_allclose(_np(out), _np(flat), atol=ATOL_ATTENTION,
                               rtol=0)


def test_decode_attention_scalar_length_and_flat_multi_match_jax(rng):
    q, kt, ks, v, vs, _ = _decode_inputs(rng, "int8")
    out = tda.decode_attention(_t(q), _t(kt), _t(ks), _t(v), _t(vs), 13)
    ref = jda.decode_attention_ref(jnp.asarray(q), jnp.asarray(kt),
                                   jnp.asarray(ks), jnp.asarray(v),
                                   jnp.asarray(vs), jnp.asarray(13))
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL_ATTENTION, rtol=0)
    qm = rng.normal(size=(8, 3, 16)).astype(np.float32) * 0.3
    multi = tda.decode_attention_flat_multi(_t(qm), _t(kt), _t(ks), _t(v),
                                            _t(vs), 15)
    jmulti = jda.decode_attention_flat_multi(
        jnp.asarray(qm), jnp.asarray(kt), jnp.asarray(ks), jnp.asarray(v),
        jnp.asarray(vs), jnp.asarray(15))
    np.testing.assert_allclose(_np(multi), _np(jmulti), atol=ATOL_ATTENTION,
                               rtol=0)


@pytest.mark.parametrize("bits,group_size", [(8, None), (4, None), (8, 32),
                                             (4, 32)])
def test_quant_matmul_matches_jax(rng, bits, group_size):
    w = rng.normal(size=(64, 200)).astype(np.float32) * 0.05
    x = rng.normal(size=(5, 64)).astype(np.float32)
    jw = jq.quantize_weight(jnp.asarray(w), bits, group_size)
    tw = tq.quantize_weight(_t(w), bits, group_size)
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    np.testing.assert_allclose(tw.scale.numpy(), np.asarray(jw.scale),
                               rtol=1e-6, atol=0)
    assert (tw.bits, tw.d_out) == (jw.bits, jw.d_out) == (bits, 200)
    np.testing.assert_array_equal(tq.unpack_int4(tw.q).numpy() if bits == 4
                                  else tw.q.numpy(),
                                  np.asarray(jq.unpack_int4(jw.q)) if bits == 4
                                  else np.asarray(jw.q))
    out = tq.quant_matmul(_t(x), tw)
    ref = jq.quant_matmul(jnp.asarray(x), jw)
    assert out.shape == (5, 200)
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL_ATTENTION, rtol=0)
    np.testing.assert_allclose(
        tq.dequantize_weight(tw, torch.float32).numpy(),
        np.asarray(jq.dequantize_weight(jw, jnp.float32)), atol=0, rtol=0)


def test_quant_linear_and_activation_quant_match_jax(rng):
    w = rng.normal(size=(64, 96)).astype(np.float32) * 0.05
    b = rng.normal(size=(96,)).astype(np.float32) * 0.1
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    jp = jq.quantize_linear_params({"kernel": jnp.asarray(w),
                                    "bias": jnp.asarray(b)})
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    np.testing.assert_allclose(
        _np(tq.quant_linear(_t(x), tp)),
        _np(jq.quant_linear(jnp.asarray(x), jp)), atol=ATOL_ATTENTION, rtol=0)
    a = rng.normal(size=(4, 16, 8)).astype(np.float32)
    for axis in (1, 2):
        tq8, ts = tq.quantize_activations_int8(_t(a), axis=axis)
        jq8, js = jq.quantize_activations_int8(jnp.asarray(a), axis=axis)
        np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    packed = tq.pack_int4_last(_t(rng.integers(-8, 8, (3, 10)).astype(np.int8)))
    np.testing.assert_array_equal(
        tq.unpack_int4_last(packed).numpy(),
        np.asarray(jq.unpack_int4_last(jnp.asarray(packed.numpy()))))


@pytest.mark.parametrize("case", ["causal", "lengths_offsets"])
def test_flash_attention_matches_jax(rng, case):
    b, sq, h, d = 2, 8, 2, 16
    sk = 8 if case == "causal" else 24
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    scale = 0.3
    kw_t, kw_j = {}, {}
    if case == "lengths_offsets":
        lens = np.array([0, 19], np.int32)     # row 0 fully masked
        offs = np.array([3, 11], np.int32)
        kw_t = dict(seq_lengths=_t(lens), q_offsets=_t(offs))
        kw_j = dict(seq_lengths=jnp.asarray(lens), q_offsets=jnp.asarray(offs))
    out, lse = tfa.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                   softmax_scale=scale, return_lse=True,
                                   **kw_t)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, softmax_scale=scale, **kw_j)
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL_ATTENTION, rtol=0)
    _, jlse = jfa._flash_fwd(
        jnp.swapaxes(jnp.asarray(q), 1, 2), jnp.swapaxes(jnp.asarray(k), 1, 2),
        jnp.swapaxes(jnp.asarray(v), 1, 2), kw_j.get("seq_lengths"), scale,
        True, 256, 256, q_offsets=kw_j.get("q_offsets"))
    np.testing.assert_allclose(_np(lse), _np(jlse), atol=ATOL_ATTENTION,
                               rtol=1e-6)


@pytest.mark.parametrize("case", ["causal", "lengths_offsets"])
def test_mha_and_mha_reference_match_jax(rng, case):
    b, sq, h, d = 2, 6, 2, 16
    sk = 6 if case == "causal" else 20
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    kw_t, kw_j, kpm = {}, {}, None
    if case == "lengths_offsets":
        lens = np.array([9, 20], np.int32)
        offs = np.array([3, 14], np.int32)
        kpm = np.arange(sk)[None, :] < lens[:, None]
        kw_t = dict(q_offset=_t(offs))
        kw_j = dict(q_offset=jnp.asarray(offs),
                    key_padding_mask=jnp.asarray(kpm))
    ref = jatt.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, softmax_scale=0.3, **kw_j)
    out_ref = tatt.mha_reference(
        _t(q), _t(k), _t(v), causal=True, softmax_scale=0.3,
        key_padding_mask=None if kpm is None else _t(kpm), **kw_t)
    out = tatt.mha(_t(q), _t(k), _t(v), causal=True, softmax_scale=0.3,
                   seq_lengths=None if kpm is None else _t(lens), **kw_t)
    np.testing.assert_allclose(_np(out_ref), _np(ref), atol=ATOL_ATTENTION,
                               rtol=0)
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL_ATTENTION,
                               rtol=0)


def test_fused_contextualization_matches_jax(rng):
    b, s, nv, dnv, d = 2, 12, 4, 8, 16
    q = rng.normal(size=(b, s, nv, dnv)).astype(np.float32)
    k = rng.normal(size=(b, s, nv, dnv)).astype(np.float32)
    c = rng.normal(size=(b, s, nv, d)).astype(np.float32)
    scale = dnv ** -0.5
    out = tbk.fused_contextualization(_t(q), _t(k), _t(c), scale)
    assert out.shape == (b, s, d)
    fused = jbk.fused_contextualization(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(c), scale)
    ref = jbk.contextualization_reference(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(c), scale)
    np.testing.assert_allclose(_np(out), _np(fused), atol=ATOL_ATTENTION,
                               rtol=0)
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL_ATTENTION, rtol=0)


def test_norms_linear_mlp_match_jax(rng):
    d = 32
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    res = rng.normal(size=(2, 5, d)).astype(np.float32)
    w = rng.normal(size=(d,)).astype(np.float32)
    bias = rng.normal(size=(d,)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tnorms.layer_norm(_t(x), _t(w), _t(bias))),
        _np(jax.jit(jnorms.layer_norm)(x, w, bias)),
        atol=ATOL_ELEMENTWISE, rtol=0)
    for residual in (None, res):
        tn, tr = tnorms.dropout_add_layer_norm(
            _t(x), None if residual is None else _t(residual), _t(w), _t(bias))
        jn, jr = jax.jit(lambda a, r: jnorms.dropout_add_layer_norm(
            a, r, w, bias))(x, residual)
        assert tr.dtype == torch.float32 and tn.dtype == torch.float32
        np.testing.assert_allclose(_np(tn), _np(jn), atol=ATOL_ELEMENTWISE,
                                   rtol=0)
        np.testing.assert_allclose(_np(tr), _np(jr), atol=ATOL_ELEMENTWISE,
                                   rtol=0)
    mlp = {"fc1": {"kernel": rng.normal(size=(d, 4 * d)).astype(np.float32)
                   * 0.1,
                   "bias": rng.normal(size=(4 * d,)).astype(np.float32) * 0.1},
           "fc2": {"kernel": rng.normal(size=(4 * d, d)).astype(np.float32)
                   * 0.1,
                   "bias": rng.normal(size=(d,)).astype(np.float32) * 0.1}}
    tmlp = params_from_numpy(mlp, device="cpu")
    np.testing.assert_allclose(
        _np(tdense.linear(_t(x), tmlp["fc1"])),
        _np(jax.jit(jdense.linear)(x, mlp["fc1"])),
        atol=ATOL_ELEMENTWISE, rtol=0)
    for act in ("gelu_new", "gelu"):
        np.testing.assert_allclose(
            _np(tdense.mlp(_t(x), tmlp, act)),
            _np(jax.jit(lambda a, p: jdense.mlp(a, p, act))(x, mlp)),
            atol=ATOL_ELEMENTWISE, rtol=0)
