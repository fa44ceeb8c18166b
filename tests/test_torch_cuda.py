"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (decided inside the test). On a machine with an NVIDIA GPU and nvcc:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX, which this file
does not use.) Shapes are deliberately ragged: window slices of larger
caches, lengths 0 and S, row counts off the tile sizes. f32 kernels must
match the f32 plain version closely; bf16 ones must keep their error
against an f32 reference within twice the bf16 plain version's.
"""

import pytest
import torch

from backpacks_flash_attn_tpu_torch.ops import _build
from backpacks_flash_attn_tpu_torch.ops import backpack_kernels as bk
from backpacks_flash_attn_tpu_torch.ops import decode_attention as da
from backpacks_flash_attn_tpu_torch.ops import flash_attention as fa
from backpacks_flash_attn_tpu_torch.ops import quant

pytestmark = pytest.mark.cuda
F32_ATOL = 1e-5     # f32 sums in another order


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _err(a, ref):
    return (a.float() - ref.float()).abs().max().item()


def _within_2x(out, plain, ref):
    ek, ep = _err(out, ref), _err(plain, ref)
    assert ep > 0 and ek <= 2 * ep, (ek, ep)


@pytest.mark.parametrize("qdt,kvdt,E,S,dv", [
    (torch.float32, torch.float32, 6, 300, 64),
    (torch.float32, torch.int8, 5, 40, 768),
    (torch.bfloat16, torch.int8, 6, 100, 64),
    (torch.bfloat16, torch.bfloat16, 6, 33, 768),
])
def test_decode_attention_kernel(gen, qdt, kvdt, E, S, dv):
    dk, dev = 64, "cuda"
    q = (torch.randn(E, dk, generator=gen, device=dev) * 0.3).to(qdt)
    if kvdt == torch.int8:
        kt = torch.randint(-127, 128, (E, dk, S + 16), generator=gen, device=dev,
                           dtype=torch.int8)
        v = torch.randint(-127, 128, (E, S + 16, dv), generator=gen, device=dev,
                          dtype=torch.int8)
        ks = torch.rand(E, S + 16, generator=gen, device=dev)[:, :S] * 0.02
        vs = torch.rand(E, S + 16, generator=gen, device=dev)[:, :S] * 0.02
    else:
        kt = torch.randn(E, dk, S + 16, generator=gen, device=dev).to(kvdt)
        v = torch.randn(E, S + 16, dv, generator=gen, device=dev).to(kvdt)
        ks = vs = None
    kt, v = kt[:, :, :S], v[:, :S]                       # window slices
    lens = torch.tensor([0, 1, S // 2, S, 7, 3][:E], dtype=torch.int32,
                        device=dev)
    for length in (lens, 5):
        before = _build.KERNELS["decode_attention"].launches
        out = da.decode_attention(q, kt, ks, v, vs, length)
        assert _build.KERNELS["decode_attention"].launches == before + 1
        ref = da.decode_attention_ref(q.float(), kt.float(), ks, v.float(), vs,
                                      length)
        if qdt == torch.float32:
            assert _err(out, ref) <= F32_ATOL
        else:
            _within_2x(out, da.decode_attention_ref(q, kt, ks, v, vs, length), ref)


@pytest.mark.parametrize("bits,gs,M,K,N", [(8, None, 70, 64, 200),
                                           (4, None, 5, 96, 256),
                                           (8, 32, 3, 64, 130),
                                           (4, 32, 65, 64, 100)])
def test_quant_matmul_kernel(gen, bits, gs, M, K, N):
    w = torch.randn(K, N, generator=gen, device="cuda") * 0.05
    qw = quant.quantize_weight(w, bits, gs)
    x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
    out = quant.quant_matmul(x, qw)
    assert out.shape == (M, N) and out.dtype == torch.bfloat16
    _within_2x(out, quant.quant_matmul_ref(x, qw),
               quant.quant_matmul_ref(x.float(), qw))
    with pytest.raises(ValueError):
        quant.quant_matmul(x.float(), qw)        # the kernel takes bf16 only


@pytest.mark.parametrize("dt,b,sq,sk,lens,offs,causal", [
    (torch.float32, 2, 70, 70, None, None, True),
    (torch.float32, 2, 9, 80, [0, 33], [5, 24], True),
    (torch.bfloat16, 2, 40, 40, None, None, True),
    (torch.float32, 1, 20, 50, [50], None, False),
])
def test_flash_attention_kernel(gen, dt, b, sq, sk, lens, offs, causal):
    h, dev = 3, "cuda"
    r = lambda s: torch.randn(*s, generator=gen, device=dev).to(dt)
    q, k, v = r((b, sq, h, 64)), r((b, sk, h, 64)), r((b, sk, h, 64))
    kw = dict(causal=causal, softmax_scale=0.2,
              seq_lengths=None if lens is None else torch.tensor(lens, device=dev),
              q_offsets=None if offs is None else torch.tensor(offs, device=dev))
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    ref, rlse = fa.flash_attention_ref(q.float(), k.float(), v.float(),
                                       return_lse=True, **kw)
    assert torch.allclose(lse, rlse, rtol=1e-5, atol=1e-4)
    if dt == torch.float32:
        assert _err(out, ref) <= F32_ATOL
    else:
        _within_2x(out, fa.flash_attention_ref(q, k, v, **kw), ref)


@pytest.mark.parametrize("dt,b,s,nv,dnv,d,misalign", [
    (torch.float32, 2, 40, 3, 48, 144, 0),
    (torch.bfloat16, 1, 33, 4, 48, 128, 0),      # tensor-core path
    (torch.bfloat16, 2, 100, 3, 40, 800, 0),     # two d chunks, the second partial
    (torch.bfloat16, 1, 70, 2, 48, 96, 1),       # unaligned content: SIMT path
    (torch.bfloat16, 1, 40, 17, 44, 64, 0),      # dnv % 8 != 0: SIMT path
])
def test_fused_contextualization_kernel(gen, dt, b, s, nv, dnv, d, misalign):
    qk = torch.randn(b, s, 2, nv, dnv, generator=gen, device="cuda").to(dt)
    q, k = qk[:, :, 0], qk[:, :, 1]                      # strided views
    c = torch.randn(b, s, nv, d + misalign, generator=gen,
                    device="cuda").to(dt)[..., misalign:]
    out = bk.fused_contextualization(q, k, c, dnv ** -0.5)
    ref = bk.contextualization_reference(q.float(), k.float(), c.float(),
                                         dnv ** -0.5)
    if dt == torch.float32:
        assert _err(out, ref) <= F32_ATOL
    else:
        _within_2x(out, bk.contextualization_reference(q, k, c, dnv ** -0.5), ref)
