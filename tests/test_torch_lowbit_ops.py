"""The port's low-bit cache primitives and K8's plain versions against the
JAX package's, on the CPU.

The same numpy-seeded inputs go through both packages. The int4 packing
helpers must agree bit for bit. The plain K8 functions (int4 and mixed,
flat and stacked) are held in f32 against JAX's XLA forms and against
JAX's Pallas kernels run in interpret mode, as tests/ops/test_decode_int4.py
runs them: rtol 1e-5 (f32 sums in another order; the Pallas kernel's online
softmax rescales by blocks), with atol 1e-6 for entries near zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu.ops import decode_attention as jda
from backpacks_flash_attn_tpu.ops import quant as jq
from backpacks_flash_attn_tpu_torch.ops import _build
from backpacks_flash_attn_tpu_torch.ops import decode_attention as tda
from backpacks_flash_attn_tpu_torch.ops import quant as tq

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_pack_unpack_int4_pairs_bit_equal(axis):
    x = np.random.default_rng(0).integers(-8, 8, (4, 6, 8)).astype(np.int8)
    jp = np.asarray(jq.pack_int4_pairs(jnp.asarray(x), axis))
    tp = tq.pack_int4_pairs(_t(x), axis)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tq.unpack_int4_pairs(tp, axis).numpy(), x)
    np.testing.assert_array_equal(
        tq.unpack_int4_pairs(tp, axis).numpy(),
        np.asarray(jq.unpack_int4_pairs(jnp.asarray(jp), axis)))


def test_unpack_split_halves_bit_equal():
    p = np.random.default_rng(1).integers(-128, 128, (3, 10)).astype(np.int8)
    jlo, jhi = jq.unpack_int4_pairs_split(jnp.asarray(p))
    tlo, thi = tq.unpack_int4_pairs_split(_t(p))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    assert tlo.dtype == thi.dtype == torch.int8


@pytest.mark.parametrize("parity", [0, 1, "per-row"])
def test_rmw_nibble_bit_equal(parity):
    rng = np.random.default_rng(2)
    old = rng.integers(-128, 128, (5, 3)).astype(np.int8)
    nib = rng.integers(-7, 8, (5, 3)).astype(np.int8)
    par = (rng.integers(0, 2, (5, 1)).astype(np.int32) if parity == "per-row"
           else parity)
    jnew = jq.rmw_nibble(jnp.asarray(old), jnp.asarray(nib), jnp.asarray(par))
    tnew = tq.rmw_nibble(_t(old), _t(nib),
                         _t(par) if parity == "per-row" else par)
    np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
    # the other nibble survives
    lo0, hi0 = tq.unpack_int4_pairs_split(_t(old))
    lo, hi = tq.unpack_int4_pairs_split(tnew)
    p = np.broadcast_to(np.asarray(par), old.shape)
    np.testing.assert_array_equal(np.where(p == 0, hi, lo),
                                  np.where(p == 0, hi0, lo0))
    np.testing.assert_array_equal(np.where(p == 0, lo, hi), nib)


@pytest.mark.parametrize("axis", [1, 2])
def test_quantize_activations_int4_bit_equal(axis):
    x = (np.random.default_rng(3).normal(size=(4, 32, 6)) * 3).astype(np.float32)
    jqv, jsc = jq.quantize_activations_int4(jnp.asarray(x), axis=axis)
    tqv, tsc = tq.quantize_activations_int4(_t(x), axis=axis)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    assert int(tqv.abs().max()) <= 7


def test_interleave_pair_scales_equal():
    sc = np.random.default_rng(4).random((3, 2, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tq.interleave_pair_scales(_t(sc)).numpy(),
        np.asarray(jq.interleave_pair_scales(jnp.asarray(sc))))


def _problem(kind, e=6, s=512, dk=16, dv=24, seed=0, layers=1):
    """Packed operands (numpy) as the caches hold them: int4 keys
    (e, dk, s/2) or split int8 keys (e, dk, 2, s/2), int4 values
    (e, s/2, dv), parity scales (e, 2, s/2); a leading layer axis when
    layers > 1."""
    rng = np.random.default_rng(seed)
    lead = (layers,) if layers > 1 else ()
    q = (rng.normal(size=(e, dk)) * 0.3).astype(np.float32)
    kshape = (e, dk, 2, s // 2) if kind == "mixed" else (e, dk, s // 2)
    lo = -127 if kind == "mixed" else -128
    k = rng.integers(lo, 128, lead + kshape).astype(np.int8)
    v = rng.integers(-128, 128, lead + (e, s // 2, dv)).astype(np.int8)
    # int8 keys span 16x the int4 range: scale them down so that the
    # scores, like the model's, stay O(1)
    ks = ((rng.random(lead + (e, 2, s // 2)) * 0.3 + 0.01)
          / (16 if kind == "mixed" else 1)).astype(np.float32)
    vs = (rng.random(lead + (e, 2, s // 2)) * 0.3 + 0.01).astype(np.float32)
    return q, k, ks, v, vs


_JAX_FLAT = {"int4": jda.decode_attention_flat_int4,
             "mixed": jda.decode_attention_flat_mixed}
_JAX_PALLAS = {"int4": jda.decode_attention_int4_blockdiag,
               "mixed": jda.decode_attention_mixed_blockdiag}
_PORT_FLAT = {"int4": tda.decode_attention_flat_int4,
              "mixed": tda.decode_attention_flat_mixed}
_PORT = {"int4": tda.decode_attention_int4, "mixed": tda.decode_attention_mixed}


@pytest.mark.parametrize("kind", ["int4", "mixed"])
@pytest.mark.parametrize("length", ["ragged", 301, 512])
def test_lowbit_decode_plain_matches_jax_flat_and_pallas(kind, length):
    """Per-row lengths (odd and even, 1 and the full 512) and scalar odd
    and full lengths. S/2 = 256 packed columns: the Pallas kernel in
    interpret mode walks them in two 128-column blocks, so its online
    softmax crosses a block."""
    q, k, ks, v, vs = _problem(kind)
    lens = (np.array([1, 2, 7, 300, 511, 512], np.int32) if length == "ragged"
            else length)
    args = [jnp.asarray(a) for a in (q, k, ks, v, vs)] + [jnp.asarray(lens)]
    targs = [_t(a) for a in (q, k, ks, v, vs)] + [
        _t(lens) if length == "ragged" else lens]
    out = _PORT_FLAT[kind](*targs)
    assert out.shape == (6, 24) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(_JAX_FLAT[kind](*args)),
                               rtol=RTOL, atol=ATOL)
    pallas = _JAX_PALLAS[kind](*args, rows_per_program=2, block_s2=128)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(_PORT[kind](*targs), out)      # CPU: the plain path


@pytest.mark.parametrize("kind", ["int4", "mixed"])
@pytest.mark.parametrize("window_cols", [None, 5])
def test_lowbit_decode_stacked_matches_jax(kind, window_cols):
    """Layer 1 of stacked (3, ...) caches; window_cols = 5 packed columns
    (a 10-position window of 32; JAX's XLA form reads all 16 columns,
    masked)."""
    q, k, ks, v, vs = _problem(kind, s=32, layers=3, seed=5)
    lens = np.array([1, 4, 9, 10, 3, 6], np.int32)
    stacked = {"int4": jda.decode_attention_int4_stacked,
               "mixed": jda.decode_attention_mixed_stacked}[kind]
    jout = stacked(1, *(jnp.asarray(a) for a in (q, k, ks, v, vs)),
                   jnp.asarray(lens), window_cols=window_cols)[0]
    tstacked = {"int4": tda.decode_attention_int4_stacked,
                "mixed": tda.decode_attention_mixed_stacked}[kind]
    tout = tstacked(1, *(_t(a) for a in (q, k, ks, v, vs)), _t(lens),
                    window_cols=window_cols)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)


def test_lowbit_wrappers_take_plain_path_on_cpu_and_count_no_launch():
    _build.reset_launches()
    for kind in ("int4", "mixed"):
        q, k, ks, v, vs = (_t(a) for a in _problem(kind, seed=6))
        assert torch.equal(_PORT[kind](q.bfloat16(), k, ks, v, vs, 9),
                           _PORT_FLAT[kind](q.bfloat16(), k, ks, v, vs, 9))
    counts = _build.launch_counts()
    assert counts["lowbit_decode_int4"] == counts["lowbit_decode_mixed"] == 0
