"""K2's launch schedule (``ops/quant.py`` ``_k2_schedule``) and its wrapper's
plain route, on the CPU: no JAX and no card needed.

The schedule is a plain function whose result the C entry takes as it is,
so its promises are checked here: at decode (M = 128) every linear of the
main path launches at least a full wave of CTAs on the H100's 132 SMs, the
K chunks cover the input width exactly once in slices the kernel takes, a
split fits one thread-block cluster, and the prefill (M = 4096) never
splits.
"""

import pytest
import torch

from backpacks_flash_attn_tpu_torch.ops import quant

SMS = 132
# backpack-small's INT8 decode step: Wqkv, out_proj, fc1, fc2, ctx_attn.Wqkv
# and the lm-head (50257 columns padded to 50304)
MAIN_PATH = [(768, 2304), (768, 768), (768, 3072), (3072, 768), (768, 1536),
             (768, 50304)]
PREFILL = [(768, 2304), (768, 768), (768, 3072), (768, 50304), (3072, 768)]


def _ctas(M, N, bn, splits):
    return -(-M // 128) * (N // bn) * splits


def _check_cover(K, N, bn, splits, chunk):
    assert bn in (32, 64, 128) and N % bn == 0
    assert 1 <= splits <= 8
    assert chunk > 0 and chunk % quant._K2_SLICE == 0
    assert (splits - 1) * chunk < K <= splits * chunk
    last = K - (splits - 1) * chunk
    assert last > 0 and last % 32 == 0


@pytest.mark.parametrize("K,N", MAIN_PATH)
def test_decode_shapes_fill_the_card(K, N):
    bn, splits, chunk = quant._k2_schedule(128, K, N)
    assert _ctas(128, N, bn, splits) >= SMS
    _check_cover(K, N, bn, splits, chunk)


@pytest.mark.parametrize("K,N", PREFILL)
def test_prefill_does_not_split(K, N):
    bn, splits, chunk = quant._k2_schedule(4096, K, N)
    assert splits == 1 and chunk >= K and bn == 128


def test_chunks_cover_in_exactly_once():
    for M in (1, 5, 64, 127, 128, 129, 256, 1000, 4096):
        for K in (32, 64, 96, 160, 768, 3072):
            for N in (128, 256, 768, 2304, 50304):
                bn, splits, chunk = quant._k2_schedule(M, K, N)
                _check_cover(K, N, bn, splits, chunk)
                covered = [k for z in range(splits)
                           for k in range(z * chunk, min(K, (z + 1) * chunk))]
                assert covered == list(range(K)), (M, K, N)


@pytest.mark.parametrize("sms", [78, 114, 132])
def test_schedule_fills_the_card_it_is_given(sms):
    """The wrapper passes the device's SM count: a card with fewer SMs
    (the H100 PCIe has 114) still gets a full wave at every decode shape,
    in chunks that cover the input width."""
    for K, N in MAIN_PATH:
        bn, splits, chunk = quant._k2_schedule(128, K, N, sms)
        assert _ctas(128, N, bn, splits) >= sms, (K, N)
        _check_cover(K, N, bn, splits, chunk)


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
def test_plain_route_adds_the_bias_eagerly(bias_dtype):
    """On the CPU quant_linear is quant_matmul's plain version, then the bias
    in f32 on the rounded product, rounded again: the form K2's epilogue
    reproduces bit for bit on the card."""
    g = torch.Generator().manual_seed(0)
    qw = quant.quantize_weight(torch.randn(64, 200, generator=g) * 0.05)
    qw.bias = (torch.randn(200, generator=g) * 0.5).to(bias_dtype)
    x = torch.randn(3, 5, 64, generator=g).to(torch.bfloat16)
    y = quant.quant_matmul_ref(x, qw)
    eager = (y.float() + qw.bias.float()).to(torch.bfloat16)
    assert torch.equal(quant.quant_linear(x, qw), eager)
    assert torch.equal(quant.quant_matmul(x, qw, bias=qw.bias), eager)
    assert torch.equal(quant.quant_matmul(x, qw), y)
