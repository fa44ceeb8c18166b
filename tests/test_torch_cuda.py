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

import contextlib

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


def _k1_window(gen, qdt, kvdt, E, S, dv, offset):
    """K1's operands as windows of wider caches: q (E, 64) pre-scaled, kt
    (E, 64, S), v (E, S, dv) and (E, S) scales (int8) starting ``offset``
    columns into caches 16 columns wider (kt, scales) and ``offset`` + dv
    wide rows (v): offset 0 keeps every row 16-byte aligned, 1 (keys and
    scales) and 4 (values) leave none aligned."""
    dk, dev = 64, "cuda"
    q = (torch.randn(E, dk, generator=gen, device=dev) * 0.3).to(qdt)
    W, vo = S + 16, 4 * min(offset, 1)
    if kvdt == torch.int8:
        kt = torch.randint(-127, 128, (E, dk, W), generator=gen, device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, (E, S, dv + vo), generator=gen, device=dev,
                          dtype=torch.int8)
        ks, vs = (torch.rand(2, E, W, generator=gen, device=dev) * 0.02)[..., offset:offset + S]
    else:
        kt = torch.randn(E, dk, W, generator=gen, device=dev).to(kvdt)
        v = torch.randn(E, S, dv + vo, generator=gen, device=dev).to(kvdt)
        ks = vs = None
    return q, kt[..., offset:offset + S], ks, v[..., vo:vo + dv], vs


# (label, q dtype, cache dtype, E, S, dv, column offset, lengths): the
# redesigned K1's schedules
K1_SCHEDULES = [
    # gpt-generate's decode: 96 rows, S split over a cluster of 2
    ("gpt-generate", torch.bfloat16, torch.bfloat16, 96, 2112, 64, 0, "long"),
    # split rows of length 0 and 1 among long ones
    ("split short rows", torch.bfloat16, torch.bfloat16, 96, 2112, 64, 0, "short"),
    ("split short rows int8", torch.bfloat16, torch.int8, 40, 1000, 64, 0, "short"),
    # an odd E: off the 2 rows a CTA of narrow rows (the last CTA holds one)
    ("E off rows", torch.bfloat16, torch.int8, 1537, 512, 64, 0, "ragged"),
    # aligned and unaligned windows at the GPT and combine widths
    ("gpt unaligned", torch.bfloat16, torch.int8, 300, 300, 64, 1, "ragged"),
    ("gpt bf16 unaligned", torch.bfloat16, torch.bfloat16, 200, 300, 64, 1, "ragged"),
    ("combine aligned", torch.bfloat16, torch.int8, 64, 512, 768, 0, "ragged"),
    ("combine unaligned", torch.bfloat16, torch.int8, 33, 200, 768, 1, "ragged"),
    ("combine bf16 unaligned", torch.bfloat16, torch.bfloat16, 20, 333, 768, 1, "ragged"),
    # S past the old 8192 cap: the largest cluster
    ("S 16384", torch.bfloat16, torch.bfloat16, 12, 16384, 64, 0, "long"),
    # the f32 oracles under a split, narrow and wide
    ("f32 split", torch.float32, torch.float32, 10, 1000, 64, 0, "short"),
    ("f32 int8 wide split", torch.float32, torch.int8, 9, 700, 768, 1, "short"),
]


@pytest.mark.parametrize("ml", [False, True])
@pytest.mark.parametrize("label,qdt,kvdt,E,S,dv,offset,lens", K1_SCHEDULES)
def test_decode_attention_k1_schedules(gen, ml, label, qdt, kvdt, E, S, dv, offset, lens):
    """K1 and K1-ml at each schedule of the redesigned kernel, per-row and
    scalar lengths (a scalar 0: every row empty): one launch a call; f32
    within 1e-5 of the f32 plain version, bf16 under the 2x rule against
    it; empty rows uniform over S (K1) or (0, NEG, 0) (K1-ml)."""
    dev = "cuda"
    q, kt, ks, v, vs = _k1_window(gen, qdt, kvdt, E, S, dv, offset)
    if lens == "long":
        rows = torch.randint(S - 64, S + 1, (E,), generator=gen, device=dev, dtype=torch.int32)
    else:
        rows = torch.randint(1, S + 1, (E,), generator=gen, device=dev, dtype=torch.int32)
    if lens == "short":
        rows[0], rows[1], rows[2] = 0, 1, S
    split = da._k1_schedule(E, 64, dv, S, kt.element_size(), _build.sm_count(0))[3]
    if label.startswith(("gpt-generate", "split", "S 16384", "f32", "combine aligned")):
        assert split > 1, label
    name = "decode_attention_ml" if ml else "decode_attention"
    fn = da.decode_attention_ml if ml else da.decode_attention
    ref_fn = da.decode_attention_ml_ref if ml else da.decode_attention_ref
    for length in (rows, S - 5, 0):
        before = _build.KERNELS[name].launches
        out = fn(q, kt, ks, v, vs, length)
        assert _build.KERNELS[name].launches == before + 1
        ref = ref_fn(q.float(), kt.float(), ks, v.float(), vs, length)
        if ml:
            empty = rows <= 0 if length is rows else torch.full_like(rows, length <= 0,
                                                                       dtype=torch.bool)
            assert (out[0][empty] == 0).all() and (out[1][empty] == da.NEG).all()
            assert (out[2][empty] == 0).all()
            if not empty.all():     # every row empty: both paths exact
                _ml_close(out, ref_fn(q, kt, ks, v, vs, length), ref, qdt)
        elif qdt == torch.float32:
            _f32_close(out, ref)
        else:
            _within_2x(out, ref_fn(q, kt, ks, v, vs, length), ref)


@pytest.mark.parametrize("bits,gs,M,K,N", [
    (8, None, 70, 64, 200),
    (4, None, 5, 96, 256),
    (8, 32, 3, 64, 130),
    (4, 32, 65, 64, 100),
    # the decode step's shapes at M = 128: Wqkv, out_proj, fc1, fc2,
    # ctx_attn.Wqkv (split K) and the lm-head (odd d_out, 128-column tiles)
    (8, None, 128, 768, 2304),
    (8, None, 128, 768, 768),
    (8, None, 128, 768, 3072),
    (8, None, 128, 3072, 768),
    (8, None, 128, 768, 1536),
    (8, None, 128, 768, 50257),
    # M off the 128-row tile, and the prefill's (no split, 128 x 128 tiles)
    (8, None, 1, 768, 768),
    (8, None, 127, 768, 768),
    (8, None, 129, 768, 768),
    (8, None, 4096, 768, 768),
    # grouped scales: INT4 g128 (split K) and INT8 g64
    (4, 128, 128, 3072, 768),
    (8, 64, 128, 768, 2304),
    # 128-column tiles: grouped INT4, and K = 96 (a partial slice)
    (4, 128, 256, 768, 33000),
    (8, None, 3, 96, 17000),
])
def test_quant_matmul_kernel(gen, bits, gs, M, K, N):
    w = torch.randn(K, N, generator=gen, device="cuda") * 0.05
    qw = quant.quantize_weight(w, bits, gs)
    x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
    before = _build.KERNELS["quant_matmul"].launches
    out = quant.quant_matmul(x, qw)
    assert _build.KERNELS["quant_matmul"].launches == before + 1
    assert out.shape == (M, N) and out.dtype == torch.bfloat16
    _within_2x(out, quant.quant_matmul_ref(x, qw),
               quant.quant_matmul_ref(x.float(), qw))
    with pytest.raises(ValueError):
        quant.quant_matmul(x.float(), qw)        # the kernel takes bf16 only


@pytest.mark.parametrize("bits,gs,K,N", [(8, None, 3072, 768), (4, 128, 768, 2304)])
def test_quant_matmul_is_deterministic(gen, bits, gs, K, N):
    """Split K sums its chunks' partials in a fixed order: two calls give
    the same bits."""
    assert quant._k2_schedule(128, K, quant._round_up(N, 128), _build.sm_count(0))[1] > 1
    qw = quant.quantize_weight(torch.randn(K, N, generator=gen, device="cuda") * 0.05,
                               bits, gs)
    x = torch.randn(128, K, generator=gen, device="cuda").to(torch.bfloat16)
    assert torch.equal(quant.quant_matmul(x, qw), quant.quant_matmul(x, qw))


@pytest.mark.parametrize("bias_dtype,M,K,N,gs", [
    (torch.bfloat16, 128, 768, 2304, None),     # split K
    (torch.float32, 128, 3072, 768, None),
    (torch.bfloat16, 128, 768, 50257, None),    # no split, odd d_out
    (torch.float32, 7, 96, 200, 32),            # grouped, a partial chunk
])
def test_quant_linear_fused_bias_bit_equal(gen, bias_dtype, M, K, N, gs):
    """quant_linear on the card adds the bias in K2's epilogue: bit-equal to
    quant_matmul followed by the eager f32 add."""
    qw = quant.quantize_weight(torch.randn(K, N, generator=gen, device="cuda") * 0.05,
                               8, gs)
    qw.bias = (torch.randn(N, generator=gen, device="cuda") * 0.5).to(bias_dtype)
    x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
    before = _build.KERNELS["quant_matmul"].launches
    fused = quant.quant_linear(x, qw)
    assert _build.KERNELS["quant_matmul"].launches == before + 1
    eager = (quant.quant_matmul(x, qw).float() + qw.bias.float()).to(torch.bfloat16)
    assert torch.equal(fused, eager)


@pytest.mark.parametrize("dt,b,sq,sk,lens,offs,causal,layout", [
    (torch.float32, 2, 70, 70, None, None, True, "contiguous"),
    (torch.float32, 2, 9, 80, [0, 33], [5, 24], True, "contiguous"),
    (torch.bfloat16, 2, 40, 40, None, None, True, "contiguous"),
    (torch.float32, 1, 20, 50, [50], None, False, "contiguous"),
    # bf16 on tensor cores: sq off the 128-row tile, sk off the 64-key tile
    (torch.bfloat16, 2, 150, 190, [190, 101], [40, 0], True, "contiguous"),
    # the serve prefill's 32 queries over a 512-column cache, ragged
    # offsets, one empty sequence
    (torch.bfloat16, 4, 32, 512, [0, 32, 300, 512], [0, 0, 268, 480], True,
     "contiguous"),
    (torch.bfloat16, 2, 70, 130, [130, 77], None, False, "contiguous"),
    (torch.bfloat16, 2, 200, 200, None, None, True, "packed"),     # mha's views
    (torch.bfloat16, 2, 70, 90, [90, 45], [20, 3], True, "misaligned"),  # SIMT
])
def test_flash_attention_kernel(gen, dt, b, sq, sk, lens, offs, causal, layout):
    h, dev = 3, "cuda"
    r = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dt)
    if layout == "packed":              # views of one (b, s, 3, h, d) tensor
        qkv = r(b, sq, 3, h, 64)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    elif layout == "misaligned":        # rows 2 bytes off 16: the SIMT route
        q, k, v = (r(n, s_, h, 65)[..., 1:] for n, s_ in ((b, sq), (b, sk), (b, sk)))
        assert not any(_build.aligned16(t) for t in (q, k, v))
    else:
        q, k, v = r(b, sq, h, 64), r(b, sk, h, 64), r(b, sk, h, 64)
    kw = dict(causal=causal, softmax_scale=0.2,
              seq_lengths=None if lens is None else torch.tensor(lens, device=dev),
              q_offsets=None if offs is None else torch.tensor(offs, device=dev))
    before = _build.KERNELS["flash_attention"].launches
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    assert _build.KERNELS["flash_attention"].launches == before + 1
    ref, rlse = fa.flash_attention_ref(q.float(), k.float(), v.float(),
                                       return_lse=True, **kw)
    assert torch.allclose(lse, rlse, rtol=1e-5, atol=1e-4)
    for i, n in enumerate(lens or []):
        if n == 0:                      # an empty sequence: 0 and NEG_INF
            assert (out[i] == 0).all() and (lse[i] == fa.NEG_INF).all()
    if dt == torch.float32:
        assert _err(out, ref) <= F32_ATOL
    else:
        _within_2x(out, fa.flash_attention_ref(q, k, v, **kw), ref)


@pytest.mark.parametrize("dt,b,s,nv,dnv,d,misalign,rows", [
    (torch.float32, 2, 40, 3, 48, 144, 0, None),
    (torch.bfloat16, 1, 33, 4, 48, 128, 0, None),      # tensor-core path
    (torch.bfloat16, 2, 100, 3, 40, 800, 0, None),     # five slabs, the last partial
    (torch.bfloat16, 1, 70, 2, 48, 96, 1, None),       # unaligned content: SIMT path
    (torch.bfloat16, 1, 40, 17, 44, 64, 0, None),      # dnv % 8 != 0: SIMT path
    # s off both tile widths (an odd count of 64-row tiles too), under
    # each row tiling of the wgmma kernel
    (torch.bfloat16, 1, 70, 3, 48, 768, 0, 64),
    (torch.bfloat16, 2, 200, 4, 48, 768, 0, 128),
    (torch.bfloat16, 1, 200, 3, 48, 768, 0, 64),
    (torch.bfloat16, 2, 70, 3, 48, 768, 0, 128),
    (torch.bfloat16, 1, 300, 3, 48, 768, 0, 64),
    (torch.bfloat16, 2, 512, 16, 48, 768, 0, None),    # backpack-small's widths
    (torch.bfloat16, 1, 300, 16, 40, 640, 0, None),    # backpack-mini's: a partial slab
    (torch.bfloat16, 2, 130, 16, 24, 384, 0, None),    # backpack-micro's
    (torch.bfloat16, 1, 70, 2, 48, 64, 0, None),       # d 64 on tensor cores
    (torch.bfloat16, 1, 300, 2, 32, 800, 0, 128),
])
def test_fused_contextualization_kernel(gen, monkeypatch, dt, b, s, nv, dnv, d,
                                        misalign, rows):
    if rows is not None:
        monkeypatch.setattr(bk, "_k4_rows", lambda *a: rows)
    qk = torch.randn(b, s, 2, nv, dnv, generator=gen, device="cuda").to(dt)
    q, k = qk[:, :, 0], qk[:, :, 1]                      # strided views
    c = torch.randn(b, s, nv, d + misalign, generator=gen,
                    device="cuda").to(dt)[..., misalign:]
    before = _build.KERNELS["fused_contextualization"].launches
    out = bk.fused_contextualization(q, k, c, dnv ** -0.5)
    assert _build.KERNELS["fused_contextualization"].launches == before + 1
    ref = bk.contextualization_reference(q.float(), k.float(), c.float(),
                                         dnv ** -0.5)
    if dt == torch.float32:
        assert _err(out, ref) <= F32_ATOL
    else:
        _within_2x(out, bk.contextualization_reference(q, k, c, dnv ** -0.5), ref)


def test_fused_contextualization_kernel_run_to_run(gen, monkeypatch):
    """K4's bf16 kernels sum in a fixed order: out and LSE are bit-equal
    from run to run, under both row tilings."""
    b, s, nv, dnv, d = 2, 200, 16, 48, 768
    qk = torch.randn(b, s, 2, nv, dnv, generator=gen, device="cuda").bfloat16()
    c = torch.randn(b, s, nv, d, generator=gen, device="cuda").bfloat16()
    for rows in (64, 128):
        monkeypatch.setattr(bk, "_k4_rows", lambda *a, rows=rows: rows)
        out, lse = bk._fwd_kernel(qk[:, :, 0], qk[:, :, 1], c, dnv ** -0.5)
        again, lse_again = bk._fwd_kernel(qk[:, :, 0], qk[:, :, 1], c, dnv ** -0.5)
        assert torch.equal(out, again) and torch.equal(lse, lse_again), rows


@pytest.mark.parametrize("dt,dropout_p,offs", [
    (torch.float32, 0.1, None),
    (torch.bfloat16, 0.1, None),
    (torch.float32, 0.3, [3, 17]),
    (torch.bfloat16, 0.3, [3, 17]),       # tensor cores, sq 70 over sk 90
    (torch.bfloat16, 0.2, [20, 0]),
])
def test_flash_attention_dropout_kernel(gen, dt, dropout_p, offs):
    from backpacks_flash_attn_tpu_torch.utils import prng
    b, sq, h = 2, 70, 3
    r = lambda s: torch.randn(*s, generator=gen, device="cuda").to(dt)
    q, k, v = r((b, sq, h, 64)), r((b, sq + 20, h, 64)), r((b, sq + 20, h, 64))
    kw = dict(causal=True, softmax_scale=0.2, dropout_p=dropout_p,
              q_offsets=None if offs is None else torch.tensor(offs, device="cuda"))
    if offs is None:
        k, v = k[:, :sq], v[:, :sq]
    out, lse = fa.flash_attention(q, k, v, return_lse=True,
                                  dropout_rng=prng.PRNGKey(5), **kw)
    seed = prng.seed_words(prng.PRNGKey(5))
    ref, rlse = fa.flash_attention_ref(q.float(), k.float(), v.float(),
                                       return_lse=True, seed=seed, **kw)
    assert torch.allclose(lse, rlse, rtol=1e-5, atol=1e-4)
    if dt == torch.float32:
        assert _err(out, ref) <= F32_ATOL
    else:
        _within_2x(out, fa.flash_attention_ref(q, k, v, seed=seed, **kw), ref)


def _f32_close(out, ref):
    """f32 kernel against the f32 plain version: products summed in another
    order, so the bound scales with the output's magnitude."""
    assert out.dtype == torch.float32
    assert _err(out, ref) <= F32_ATOL * max(1.0, ref.abs().max().item())


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dt,b,s,h,causal,dropout_p,key_tile,layout", [
    (BF16, 2, 70, 3, True, 0.0, None, "packed"),
    (BF16, 2, 130, 2, True, 0.1, None, "packed"),
    (BF16, 1, 96, 3, False, 0.2, None, "packed"),
    (BF16, 2, 512, 4, True, 0.1, None, "packed"),   # the training shape's rows
    # s off both key-tile widths, causal and not, at each width
    (BF16, 2, 70, 3, False, 0.1, 64, "packed"),
    (BF16, 2, 130, 2, True, 0.0, 64, "packed"),
    (BF16, 1, 200, 2, False, 0.1, 64, "packed"),
    (BF16, 2, 70, 3, True, 0.1, 128, "packed"),
    (BF16, 1, 130, 2, False, 0.0, 128, "packed"),
    (BF16, 1, 200, 2, True, 0.1, 128, "packed"),
    # heads-major views: (b, h, s, 3, 64) storage, read in place
    (BF16, 2, 200, 2, True, 0.1, 64, "bhsd"),
    (BF16, 1, 130, 3, False, 0.2, 128, "bhsd"),
    (BF16, 1, 8192, 2, True, 0.1, None, "packed"),  # train-8k's sequence
    (F32, 2, 70, 3, True, 0.0, None, "packed"),
    (F32, 2, 130, 2, True, 0.1, None, "packed"),
    (F32, 1, 45, 3, False, 0.2, None, "packed"),
])
def test_flash_attention_bwd_kernel(gen, monkeypatch, dt, b, s, h, causal,
                                    dropout_p, key_tile, layout):
    """K5 against its plain version; q, k and v are strided views of one
    packed tensor. key_tile forces the bf16 kernel's key-tile width (None:
    the wrapper's choice)."""
    if key_tile is not None:
        monkeypatch.setattr(fa, "_k5_key_tile", lambda *a: key_tile)
    if layout == "packed":
        qkv = torch.randn(b, s, 3, h, 64, generator=gen, device="cuda")
    else:
        qkv = torch.randn(b, h, s, 3, 64, generator=gen,
                          device="cuda").permute(0, 2, 3, 1, 4)
    dout = torch.randn(b, s, h, 64, generator=gen, device="cuda")
    seed = (12345, 678)
    kw = dict(causal=causal, softmax_scale=0.125, dropout_p=dropout_p,
              seed=seed)

    def grads(x, go, bwd, fwd_kernel=False):
        """Each backward takes its own path's forward, as in training (K3's
        for K5): a plain bf16 forward's LSE comes from bf16-rounded scores,
        off the f32 scores K5 recomputes."""
        q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]        # strided views
        if fwd_kernel:
            out, lse = fa._flash_fwd_kernel(
                q, k, v, scale=0.125, seq_lengths=None, q_offsets=None,
                causal=causal, dropout_p=dropout_p, seed=seed)
        else:
            out, lse = fa.flash_attention_ref(q, k, v, return_lse=True, **kw)
        return bwd(q, k, v, out, lse, go, **kw)

    x = qkv.to(dt)
    assert x.stride() == qkv.stride()       # the layout reaches the kernel
    before = _build.KERNELS["flash_attention_bwd"].launches
    kernel = grads(x, dout.to(dt), fa.flash_attention_bwd, fwd_kernel=True)
    assert _build.KERNELS["flash_attention_bwd"].launches == before + 1
    ref = grads(x.float(), dout.to(dt).float(), fa.flash_attention_bwd_ref)
    if dt == torch.float32:
        for name, a, r in zip(("dq", "dk", "dv"), kernel, ref):
            assert a.is_contiguous(), name
            _f32_close(a, r)
        return
    plain = grads(x, dout.to(dt), fa.flash_attention_bwd_ref)
    for name, a, p, r in zip(("dq", "dk", "dv"), kernel, plain, ref):
        assert a.dtype == dt and a.is_contiguous(), name
        _within_2x(a, p, r)


def test_flash_attention_bwd_kernel_run_to_run(gen, monkeypatch):
    """K5 twice on the same inputs, at each key-tile width: dk and dv are
    bit-equal (each CTA owns its keys' rows), dq, whose f32 partials land
    in an order that varies between runs, holds the 2x rule in each run."""
    b, s, h = 2, 1000, 4
    kw = dict(causal=True, softmax_scale=0.125, dropout_p=0.1, seed=(7, 9))
    q, k, v, dout = (torch.randn(b, s, h, 64, generator=gen, device="cuda")
                     for _ in range(4))
    out32, lse32 = fa.flash_attention_ref(q, k, v, return_lse=True, **kw)
    ref = fa.flash_attention_bwd_ref(q, k, v, out32, lse32, dout, **kw)
    qb, kb, vb, db = (t.to(BF16) for t in (q, k, v, dout))
    pout, plse = fa.flash_attention_ref(qb, kb, vb, return_lse=True, **kw)
    plain = fa.flash_attention_bwd_ref(qb, kb, vb, pout, plse, db, **kw)
    out, lse = fa._flash_fwd_kernel(qb, kb, vb, scale=0.125, seq_lengths=None,
                                    q_offsets=None, causal=True,
                                    dropout_p=0.1, seed=(7, 9))
    for key_tile in (64, 128):
        monkeypatch.setattr(fa, "_k5_key_tile", lambda *a: key_tile)
        first, second = (fa.flash_attention_bwd(qb, kb, vb, out, lse, db, **kw)
                         for _ in range(2))
        assert torch.equal(first[1], second[1]), key_tile     # dk
        assert torch.equal(first[2], second[2]), key_tile     # dv
        for run in (first, second):
            _within_2x(run[0], plain[0], ref[0])


@pytest.mark.parametrize("dt,expanded,dropout_p,s", [
    (torch.bfloat16, False, 0.1, 64),
    (torch.bfloat16, True, 0.1, 64),
    (torch.float32, True, 0.1, 64),
    # K3's tensor-core forward then K5 at p = 0.3: both must draw the same
    # keep mask, or the gradients leave the 2x rule
    (torch.bfloat16, False, 0.3, 200),
])
def test_flash_attention_autograd_launches_k3_and_k5(gen, dt, expanded,
                                                     dropout_p, s):
    """flash_attention + backward as training calls it, on the kernel path
    and on the plain path (the plain forward's own LSE into the plain
    backward), gradients against the f32 plain path."""
    from backpacks_flash_attn_tpu_torch.utils import prng
    qkv = torch.randn(2, s, 3, 2, 64, generator=gen, device="cuda").to(dt)

    def grads(x):
        x = x.detach().requires_grad_(True)
        out = fa.flash_attention(x[:, :, 0], x[:, :, 1], x[:, :, 2],
                                 dropout_p=dropout_p,
                                 dropout_rng=prng.PRNGKey(0))
        # out.sum() hands the backward a stride-0 cotangent
        (out.sum() if expanded else out.float().square().sum()).backward()
        return x.grad

    _build.reset_launches()
    kernel = grads(qkv)
    counts = _build.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_bwd"] == 1
    assert torch.isfinite(kernel.float()).all()
    with _build.plain_path():
        ref = grads(qkv.float())
        plain = None if dt == torch.float32 else grads(qkv)
    for i, name in enumerate(("dq", "dk", "dv")):
        if dt == torch.float32:
            _f32_close(kernel[:, :, i], ref[:, :, i])
        else:
            _within_2x(kernel[:, :, i], plain[:, :, i], ref[:, :, i])


@pytest.mark.parametrize("dt,b,s,nv,dnv,d,heads", [
    (torch.bfloat16, 2, 100, 3, 48, 200, None),     # ragged tiles, slabs and d chunks
    (torch.bfloat16, 1, 64, 4, 48, 768, None),
    (torch.bfloat16, 1, 33, 2, 16, 64, None),
    (torch.bfloat16, 2, 512, 16, 48, 768, None),    # the training shape's rows
    (torch.bfloat16, 2, 512, 16, 48, 768, 16),      # ... a dcontent CTA walking all heads
    (torch.bfloat16, 1, 200, 4, 48, 768, 3),        # s off 64 and 128; head groups 3 + 1
    (torch.bfloat16, 2, 1, 3, 48, 768, None),       # s = 1
    (torch.bfloat16, 1, 300, 16, 40, 640, 4),       # backpack-mini's widths: a partial slab
    (torch.bfloat16, 2, 130, 16, 24, 384, None),    # backpack-micro's, a partial last tile
    (torch.bfloat16, 1, 130, 2, 64, 1152, None),    # d past 1024: dO / content streamed per tile
    (torch.float32, 2, 100, 3, 48, 200, None),
    (torch.float32, 1, 70, 2, 44, 300, None),       # dnv and d off every tile size
])
def test_fused_contextualization_bwd_kernel(gen, monkeypatch, dt, b, s, nv, dnv, d, heads):
    """Each path's backward takes the LSE of its own forward, as in
    training: K4's for K6. (The plain bf16 forward rounds its scores to
    bf16; its LSE under K6's f32 scores skews alpha, which pushed K6's
    error past twice the plain path's at the training shape.) ``heads``
    forces the sense heads a dcontent CTA walks."""
    if heads is not None:
        monkeypatch.setattr(bk, "_k6_heads", lambda *a: heads)
    qk = torch.randn(b, s, 2, nv, dnv, generator=gen, device="cuda")
    c = torch.randn(b, s, nv, d, generator=gen, device="cuda")
    g = torch.randn(b, s, d, generator=gen, device="cuda")
    scale = dnv ** -0.5

    def grads(x, cc, gg, bwd):
        q, k = x[:, :, 0], x[:, :, 1]                        # strided views
        if bwd is bk.fused_ctx_bwd:
            _, lse = bk._fwd_kernel(q, k, cc, scale)
        else:
            _, lse = bk.contextualization_reference(q, k, cc, scale,
                                                    return_lse=True)
        return bwd(q, k, cc, lse, gg, scale)

    before = _build.KERNELS["fused_contextualization_bwd"].launches
    kernel = grads(qk.to(dt), c.to(dt), g.to(dt), bk.fused_ctx_bwd)
    assert _build.KERNELS["fused_contextualization_bwd"].launches == before + 1
    ref = grads(qk.to(dt).float(), c.to(dt).float(), g.to(dt).float(),
                bk.fused_ctx_bwd_ref)
    if dt == torch.float32:
        for a, r in zip(kernel, ref):
            _f32_close(a, r)
        return
    plain = grads(qk.to(dt), c.to(dt), g.to(dt), bk.fused_ctx_bwd_ref)
    for name, a, p, r in zip(("dq", "dk", "dc"), kernel, plain, ref):
        assert a.dtype == dt, name
        if s == 1:
            # alpha is 1: dS is 0 and dcontent is dO, exactly on both plain
            # paths; K6's two passes may round dP apart in f32, so dq and dk
            # are held to f32 rounding of the largest |dO . c| instead
            assert _err(p, r) == 0, name
            tol = 1e-5 * max(1.0, (g.float() * c.float()[:, :, 0]).sum(-1).abs().max().item())
            assert _err(a, r) <= tol, (name, _err(a, r))
        else:
            _within_2x(a, p, r)


def test_fused_contextualization_bwd_kernel_run_to_run(gen):
    """K6 twice on the same inputs: dk and dcontent are bit-equal (each CTA
    owns its rows and sums in a fixed order); dq, whose f32 partials land in
    its accumulator by atomics in an order that varies between runs, may
    differ in its last bits, and holds the 2x rule in each run."""
    b, s, nv, dnv, d = 2, 300, 4, 48, 768
    qk = torch.randn(b, s, 2, nv, dnv, generator=gen, device="cuda").bfloat16()
    c = torch.randn(b, s, nv, d, generator=gen, device="cuda").bfloat16()
    g = torch.randn(b, s, d, generator=gen, device="cuda").bfloat16()
    q, k = qk[:, :, 0], qk[:, :, 1]
    scale = dnv ** -0.5
    _, lse = bk._fwd_kernel(q, k, c, scale)
    first, second = (bk.fused_ctx_bwd(q, k, c, lse, g, scale) for _ in range(2))
    assert torch.equal(first[1], second[1])     # dk
    assert torch.equal(first[2], second[2])     # dcontent
    _, plse = bk.contextualization_reference(q, k, c, scale, return_lse=True)
    plain = bk.fused_ctx_bwd_ref(q, k, c, plse, g, scale)
    _, lse32 = bk.contextualization_reference(q.float(), k.float(), c.float(), scale,
                                              return_lse=True)
    ref = bk.fused_ctx_bwd_ref(q.float(), k.float(), c.float(), lse32, g.float(), scale)
    for run in (first, second):
        _within_2x(run[0], plain[0], ref[0])


@pytest.mark.parametrize("dt,misalign", [(torch.bfloat16, 0),   # tensor cores
                                         (torch.bfloat16, 1),   # SIMT
                                         (torch.float32, 0)])
def test_fused_contextualization_lse_and_autograd(gen, dt, misalign):
    b, s, nv, dnv, d = 2, 70, 3, 48, 96
    qk = torch.randn(b, s, 2, nv, dnv, generator=gen, device="cuda").to(dt)
    c = torch.randn(b, s, nv, d + misalign, generator=gen,
                    device="cuda").to(dt)[..., misalign:]
    q, k = qk[:, :, 0], qk[:, :, 1]
    _, lse = bk._fwd_kernel(q, k, c, 0.3)
    _, rlse = bk.contextualization_reference(q.float(), k.float(), c.float(),
                                             0.3, return_lse=True)
    assert torch.allclose(lse, rlse, rtol=1e-4, atol=1e-3)
    if not misalign:
        x = qk.detach().requires_grad_(True)
        cc = c.detach().requires_grad_(True)
        _build.reset_launches()
        out = bk.fused_contextualization(x[:, :, 0], x[:, :, 1], cc, 0.3)
        out.float().sum().backward()
        counts = _build.launch_counts()
        assert counts["fused_contextualization"] == 1
        assert counts["fused_contextualization_bwd"] == 1
        assert torch.isfinite(x.grad.float()).all()
        assert torch.isfinite(cc.grad.float()).all()


def test_train_cli_smoke_at_its_defaults(gen, tmp_path):
    """The training CLI on the card at its default dtype (f32) and model
    (backpack-micro), as a user would start it: K3 and K5 in f32."""
    import numpy as np
    from backpacks_flash_attn_tpu_torch.data import lm_dataset as lmd
    from backpacks_flash_attn_tpu_torch.training import train_cli

    rc = train_cli.RunConfig(corpus="unused", workdir=str(tmp_path / "run"),
                             mode="smoke")
    assert (rc.dtype, rc.device) == ("float32", "cuda")
    tokens = np.random.default_rng(0).integers(0, 4096, 40_000)
    rc.corpus = lmd.save_corpus(tokens.astype(np.uint16), str(tmp_path), "c")
    _build.reset_launches()
    out = train_cli.run(rc)
    counts = _build.launch_counts()
    assert out["steps"] == 3 and np.isfinite(out["final_metrics"]["loss"])
    assert np.isfinite(out["val"]["ppl"])
    assert counts["flash_attention"] > 0 and counts["flash_attention_bwd"] > 0


@pytest.mark.parametrize("kind,qdt,dv", [
    ("int4", torch.float32, 64),
    ("int4", torch.bfloat16, 64),
    ("int4", torch.bfloat16, 48),               # 85 column groups
    ("mixed", torch.float32, 768),
    ("mixed", torch.bfloat16, 768),
])
def test_lowbit_decode_attention_kernel(gen, kind, qdt, dv):
    """K8 on layer 1 of stacked (3, ...) caches under a 100-column window
    (both strided views, read in place): rows of length 0 (uniform over
    the window), 1, odd and even, the window's full 200 positions, and a
    scalar odd length."""
    L, E, dk, S2, w = 3, 6, 64, 160, 100
    dev = "cuda"
    stacked = (da.decode_attention_mixed_stacked if kind == "mixed"
               else da.decode_attention_int4_stacked)
    name = f"lowbit_decode_{kind}"
    q = (torch.randn(E, dk, generator=gen, device=dev) * 0.3).to(qdt)
    kshape = (L, E, dk, 2, S2) if kind == "mixed" else (L, E, dk, S2)
    keys = torch.randint(-127, 128, kshape, generator=gen, device=dev,
                         dtype=torch.int8)
    v = torch.randint(-128, 128, (L, E, S2, dv), generator=gen, device=dev,
                      dtype=torch.int8)
    kscale = 0.05 / (16 if kind == "mixed" else 1)
    ks = torch.rand(L, E, 2, S2, generator=gen, device=dev) * kscale
    vs = torch.rand(L, E, 2, S2, generator=gen, device=dev) * 0.05
    lens = torch.tensor([0, 1, 2, 77, 2 * w - 1, 2 * w], dtype=torch.int32,
                        device=dev)
    for length in (lens, 37):
        args = (keys, ks, v, vs, length)
        before = _build.KERNELS[name].launches
        out = stacked(1, q, *args, window_cols=w)
        assert _build.KERNELS[name].launches == before + 1
        with _build.plain_path():
            plain = stacked(1, q, *args, window_cols=w)
            ref = stacked(1, q.float(), *args, window_cols=w)
        assert out.shape == (E, dv) and out.dtype == qdt
        if qdt == torch.float32:
            _f32_close(out, ref)
        else:
            _within_2x(out, plain, ref)


def test_quant_gates_cli_smoke(gen, tmp_path):
    """The quant-gates CLI on the card, at smoke size, on the workdir of a
    2-step run of the training CLI (backpack-micro at its f32 default):
    INT8 and grouped INT4 weights through K2, the cached prefill over the
    four cache configurations through K3."""
    import json
    from contextlib import redirect_stdout
    from io import StringIO

    import numpy as np
    from backpacks_flash_attn_tpu_torch.data import lm_dataset as lmd
    from backpacks_flash_attn_tpu_torch.eval import quant_gates
    from backpacks_flash_attn_tpu_torch.training import train_cli

    tokens = np.random.default_rng(1).integers(0, 4096, 40_000)
    corpus = lmd.save_corpus(tokens.astype(np.uint16), str(tmp_path), "c")
    workdir = str(tmp_path / "run")
    train_cli.run(train_cli.RunConfig(corpus=corpus, workdir=workdir,
                                      steps=2, seqlen=128, warmup_steps=1))
    _build.reset_launches()
    buf = StringIO()
    with redirect_stdout(buf):
        quant_gates.main(["--workdir", workdir, "--corpus", corpus,
                          "--seqlen", "128", "--max-batches", "1",
                          "--val-fraction", "0.05"])
    counts = _build.launch_counts()
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["checkpoint_step"] == 2
    for key, value in out.items():
        assert np.isfinite(value), key
    assert counts["quant_matmul"] > 0 and counts["flash_attention"] > 0


def _ml_close(out, plain, ref, qdt):
    """(out, m, l) of an (m, l) kernel form: each output within 1e-5 of
    the f32 plain version (f32), or under the 2x rule (bf16)."""
    for o, p, r in zip(out, plain, ref):
        if qdt == torch.float32:
            _f32_close(o, r)
        else:
            _within_2x(o, p, r)


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
def test_lowbit_decode_int4_ml_kernel(gen, qdt):
    """K8-ml on layer 1 of stacked int4 caches under a 100-column window,
    ragged base lengths with one at 0 (an empty main segment: (0, NEG, 0)),
    then merged with a stage segment as the staged decode merges them."""
    L, E, dk, dv, S2, w, C = 3, 6, 64, 64, 160, 100, 8
    dev = "cuda"
    q = (torch.randn(E, dk, generator=gen, device=dev) * 0.3).to(qdt)
    keys = torch.randint(-128, 128, (L, E, dk, S2), generator=gen, device=dev,
                         dtype=torch.int8)
    v = torch.randint(-128, 128, (L, E, S2, dv), generator=gen, device=dev,
                      dtype=torch.int8)
    ks, vs = torch.rand(2, L, E, 2, S2, generator=gen, device=dev) * 0.05
    base = torch.tensor([0, 1, 2, 77, 2 * w - 1, 2 * w], dtype=torch.int32,
                        device=dev)
    args = (keys, ks, v, vs, base)
    before = _build.KERNELS["lowbit_decode_int4_ml"].launches
    out = da.decode_attention_int4_staged_ml(1, q, *args, window_cols=w)
    assert _build.KERNELS["lowbit_decode_int4_ml"].launches == before + 1
    with _build.plain_path():
        plain = da.decode_attention_int4_staged_ml(1, q, *args, window_cols=w)
        ref = da.decode_attention_int4_staged_ml(1, q.float(), *args,
                                                 window_cols=w)
    assert (out[0][0] == 0).all() and out[1][0, 0] == da.NEG and out[2][0, 0] == 0
    _ml_close(out, plain, ref, qdt)
    k_st = torch.randint(-127, 128, (E, C, dk), generator=gen, device=dev,
                         dtype=torch.int8)
    v_st = torch.randint(-127, 128, (E, C, dv), generator=gen, device=dev,
                         dtype=torch.int8)
    ks_st, vs_st = torch.rand(2, E, C, generator=gen, device=dev) * 0.05
    pos = base[:, None] + torch.arange(C, device=dev)[None, :]
    pos[2:4, 5:] = -1
    stage = lambda qq: da.stage_segment_attention(qq, k_st, ks_st, v_st, vs_st,
                                                  pos, base + C)
    merged = da.merge_softmax_segments(*out, *stage(q))
    with _build.plain_path():
        mplain = da.merge_softmax_segments(*plain, *stage(q))
    mref = da.merge_softmax_segments(*ref, *stage(q.float()))
    if qdt == torch.float32:
        _f32_close(merged, mref)
    else:
        _within_2x(merged, mplain, mref)


@pytest.mark.parametrize("qdt,kvdt,dv", [
    (torch.float32, torch.int8, 64),
    (torch.bfloat16, torch.int8, 64),
    (torch.bfloat16, torch.int8, 768),
    (torch.bfloat16, torch.bfloat16, 768),
])
def test_decode_attention_ml_kernel_and_staged_route(gen, qdt, kvdt, dv):
    """K1-ml over a window slice, ragged base lengths with one at 0; then
    the staged decode route (K1-ml + stage segment + merge) against the
    plain one-softmax decode_attention_flat_staged."""
    E, dk, S, C, dev = 6, 64, 120, 8, "cuda"
    q = (torch.randn(E, dk, generator=gen, device=dev) * 0.3).to(qdt)
    if kvdt == torch.int8:
        kt = torch.randint(-127, 128, (E, dk, S + 8), generator=gen, device=dev,
                           dtype=torch.int8)[..., :S]
        v = torch.randint(-127, 128, (E, S + 8, dv), generator=gen, device=dev,
                          dtype=torch.int8)[:, :S]
        ks, vs = (torch.rand(2, E, S + 8, generator=gen, device=dev) * 0.02)[..., :S]
        k_st = torch.randint(-127, 128, (E, C, dk), generator=gen, device=dev,
                             dtype=torch.int8)
        v_st = torch.randint(-127, 128, (E, C, dv), generator=gen, device=dev,
                             dtype=torch.int8)
        ks_st, vs_st = torch.rand(2, E, C, generator=gen, device=dev) * 0.02
    else:
        kt = torch.randn(E, dk, S + 8, generator=gen, device=dev).to(kvdt)[..., :S]
        v = torch.randn(E, S + 8, dv, generator=gen, device=dev).to(kvdt)[:, :S]
        k_st = torch.randn(E, C, dk, generator=gen, device=dev).to(kvdt)
        v_st = torch.randn(E, C, dv, generator=gen, device=dev).to(kvdt)
        ks = vs = ks_st = vs_st = None
    base = torch.tensor([0, 1, 60, S, 7, 33], dtype=torch.int32, device=dev)
    before = _build.KERNELS["decode_attention_ml"].launches
    out = da.decode_attention_ml(q, kt, ks, v, vs, base)
    assert _build.KERNELS["decode_attention_ml"].launches == before + 1
    plain = da.decode_attention_ml_ref(q, kt, ks, v, vs, base)
    ref = da.decode_attention_ml_ref(q.float(), kt, ks, v, vs, base)
    _ml_close(out, plain, ref, qdt)
    pos = base[:, None] + torch.arange(C, device=dev)[None, :]
    pos[1, :] = -1                                   # row 1: empty stage
    lens = base + C
    st = (base, k_st, ks_st, v_st, vs_st, pos, lens)
    staged = da.decode_attention_staged(q, kt, ks, v, vs, *st)
    with _build.plain_path():
        splain = da.decode_attention_flat_staged(q, kt, ks, v, vs, *st)
    sref = da.decode_attention_flat_staged(q.float(), kt, ks, v, vs, *st)
    if qdt == torch.float32:
        _f32_close(staged, sref)
    else:
        _within_2x(staged, splain, sref)


def _backpack_d64():
    """backpack-test widened to K3's head dim of 64."""
    from backpacks_flash_attn_tpu_torch.config import BackpackConfig
    return BackpackConfig(vocab_size=512, n_positions=128, n_embd=128,
                          n_head=2, n_layer=2, num_senses=4,
                          scale_attn_by_inverse_layer_idx=True,
                          pad_vocab_size_multiple=8)


def test_serving_engine_on_the_card(gen):
    """A short ServingEngine run (backpack-test widened to K3's head dim,
    INT8 caches, a 4-column
    stage so that it flushes): every decode step launches K1's (m, l) form
    once per GPT layer and once for the combine, and plain K1 never."""
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    from backpacks_flash_attn_tpu_torch.serving.engine import ServingEngine

    cfg = _backpack_d64()
    params = bp.init_backpack(cfg, torch.Generator().manual_seed(0),
                              device="cuda")
    params["gpt"]["wte"] *= 20.0
    rng = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, 512, (n,), generator=rng).tolist()
               for n in (3, 9, 17, 5, 12)]

    eng = ServingEngine(params, cfg, max_slots=3, max_seqlen=64,
                        cache_dtype=torch.int8, eos_id=-1, stage_tokens=4)
    _build.reset_launches()
    got, stats = eng.generate(prompts, max_new_tokens=9), eng.stats()
    counts = _build.launch_counts()
    steps = stats["decode_steps"]
    assert stats["flushes"] >= 2 and all(len(t) == 9 for t in got)
    assert counts["decode_attention_ml"] == (cfg.n_layer + 1) * steps
    assert counts["decode_attention"] == 0


def test_staged_kv4_decode_launches_k8_ml(gen):
    """Staged decode over an int4 GPT cache (INT8 ctx-K and senses): K8-ml
    once per GPT layer a step, K1-ml once for the combine, through a flush;
    logits finite and within 2e-2 of the largest of the plain path's (each
    path quantizes its own activations into the caches, and a value on a
    rounding boundary may take the neighbouring int4 code in one of them;
    a wrong position or parity moves them by the logits' own size)."""
    from backpacks_flash_attn_tpu_torch.models import backpack as bp

    cfg = _backpack_d64()
    params = bp.init_backpack(cfg, torch.Generator().manual_seed(0),
                              device="cuda")
    b, steps = 3, 6
    ids = torch.randint(0, 512, (b, 8 + steps), generator=torch.Generator(
        ).manual_seed(2)).cuda()

    def decode():
        small = bp.init_backpack_cache(cfg, b, 32, torch.int8, bits=8,
                                       kv_bits=4)
        big = bp.init_backpack_cache(cfg, b, 32, torch.int8, bits=8,
                                     kv_bits=4, per_slot=True, stage=4)
        bp.backpack_forward_with_cache(params, cfg, ids[:, :8], small)
        for i in range(b):
            bp.insert_cache_slot(big, bp.extract_cache_slot(small, i, cfg), i)
        out = []
        for t in range(steps):
            if big.gpt.stage_ptr == 4:
                bp.flush_cache(big)
            logits, big = bp.backpack_forward_with_cache(
                params, cfg, ids[:, 8 + t:9 + t], big, window=16)
            out.append(logits)
        return torch.cat(out, dim=1)

    _build.reset_launches()
    got = decode()
    counts = _build.launch_counts()
    assert counts["lowbit_decode_int4_ml"] == cfg.n_layer * steps
    assert counts["decode_attention_ml"] == steps
    assert counts["lowbit_decode_int4"] == counts["decode_attention"] == 0
    with _build.plain_path():
        want = decode()
    assert torch.isfinite(got).all()
    assert _err(got, want) <= 2e-2 * want.abs().max().item()


# ------------------------------------------------------------ K7, K9

@pytest.mark.parametrize("dt,T,d_in,inner,d_out,act", [
    (torch.bfloat16, 1000, 128, 512, 128, "gelu_new"),   # ragged token tile
    (torch.bfloat16, 300, 768, 3072, 768, "gelu_new"),   # gpt3-small widths
    (torch.bfloat16, 96, 256, 512, 1024, "gelu"),        # d_out wider than d_in
    (torch.float32, 1000, 128, 512, 128, "sqrelu"),
    (torch.float32, 77, 768, 1024, 768, "relu"),
    (torch.bfloat16, 200, 1536, 1024, 1536, "gelu_new"),  # gpt3-large's d_in
    (torch.bfloat16, 70, 1280, 640, 1280, "relu"),       # five N tiles of 256 in pass 2
    (torch.float32, 50, 1280, 512, 1280, "gelu"),
    (torch.bfloat16, 1, 768, 3072, 768, "gelu_new"),     # one token
    (torch.bfloat16, 16384 - 37, 768, 3072, 768, "gelu_new"),  # train-8k's, last tile partial
    (torch.bfloat16, 130, 256, 640, 384, "relu"),        # N tiles of 128 only
    (torch.bfloat16, 257, 256, 512, 256, "gelu_fast"),
    (torch.float32, 100, 1536, 1024, 1536, "gelu_new"),  # the widest f32 case
])
def test_fused_mlp_kernel(gen, dt, T, d_in, inner, d_out, act):
    from backpacks_flash_attn_tpu_torch.ops import fused_mlp as fm
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = r(T, d_in).to(dt)
    w1, w2 = (r(d_in, inner) * d_in ** -0.5).to(dt), (r(inner, d_out) * inner ** -0.5).to(dt)
    b1, b2 = (r(inner) * 0.1).to(dt), (r(d_out) * 0.1).to(dt)
    before = _build.KERNELS["fused_mlp_fwd"].launches
    out = fm.mlp_fwd_fused(x, w1, b1, w2, b2, activation=act)
    assert _build.KERNELS["fused_mlp_fwd"].launches == before + 1
    ref = fm.mlp_fwd_fused_ref(*(t.float() for t in (x, w1, b1, w2, b2)),
                               activation=act)
    for got, want in zip(out, ref):
        assert got.dtype == dt
        if dt == torch.float32:
            _f32_close(got, want)
    if dt == torch.bfloat16:
        plain = fm.mlp_fwd_fused_ref(x, w1, b1, w2, b2, activation=act)
        for got, p, want in zip(out, plain, ref):
            _within_2x(got, p, want)


def test_fused_mlp_frees_its_scratch(gen):
    """K7 passes the activation between its two GEMM passes through a
    scratch buffer: after the call only out and h_pre stay allocated. Every
    buffer is under 1 MB and a multiple of 512 bytes, so the caching
    allocator hands out blocks of exactly their size."""
    from backpacks_flash_attn_tpu_torch.ops import fused_mlp as fm
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    T, d, inner, dt = 300, 256, 1024, torch.bfloat16
    args = [r(T, d), r(d, inner) * d ** -0.5, r(inner) * 0.1,
            r(inner, d) * inner ** -0.5, r(d) * 0.1]
    args = [t.to(dt) for t in args]
    fm.mlp_fwd_fused(*args)          # builds and loads the kernel
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    live = torch.cuda.memory_stats()["allocation.all.current"]
    out, hpre = fm.mlp_fwd_fused(*args)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.current"] == live + 2
    assert torch.cuda.memory_allocated() == before + (out.numel() + hpre.numel()) * 2


@pytest.mark.parametrize("d,inner", [(128, 512), (1536, 1024)])
def test_dense_mlp_takes_k7_under_the_switch(gen, monkeypatch, d, inner):
    """dense.mlp with BACKPACKS_FUSED_MLP's switch on: the forward launches
    K7 once, the backward recomputes from its h_pre; forward and gradients
    match the switch-off path within the bf16 rule. d 1536: gpt3-large's
    width."""
    from backpacks_flash_attn_tpu_torch.ops import dense
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    params = {"fc1": {"kernel": r(d, inner) * d ** -0.5, "bias": r(inner) * 0.1},
              "fc2": {"kernel": r(inner, d) * inner ** -0.5, "bias": r(d) * 0.1}}
    x = r(2, 40, d)
    g = r(2, 40, d)

    def run(switch, dt):
        monkeypatch.setattr(dense, "_FUSED_MLP", switch)
        p = {k: {n: t.to(dt).requires_grad_() for n, t in v.items()}
             for k, v in params.items()}
        xi = x.to(dt).requires_grad_()
        out = dense.mlp(xi, p, "gelu_new")
        out.backward(g.to(dt))
        return [out, xi.grad] + [p[k][n].grad for k in p for n in p[k]]

    before = _build.KERNELS["fused_mlp_fwd"].launches
    fused = run(True, torch.bfloat16)
    assert _build.KERNELS["fused_mlp_fwd"].launches == before + 1
    plain = run(False, torch.bfloat16)
    assert _build.KERNELS["fused_mlp_fwd"].launches == before + 1
    ref = run(False, torch.float32)
    for a, p, want in zip(fused, plain, ref):
        _within_2x(a, p, want)


def _band_mask(n_qb, n_kb, band):
    """bench_longctx.py's causal local band plus global block 0."""
    qi = torch.arange(n_qb)[:, None]
    kj = torch.arange(n_kb)[None, :]
    return (((kj <= qi) & ((qi - kj) < band)) | (kj == 0)).to(torch.int32)


def _bs_paths(act, kw, q, k, v, dout, kernel):
    """K9's forward then its backward from that forward's (out, LSE): the
    kernels (counted: one launch each) or the plain versions."""
    if kernel:
        out, lse, tables = fa._bs_fwd_kernel(q, k, v, act, **kw)
        return (out, lse, *fa._bs_bwd_kernel(q, k, v, out, lse, dout, tables, **kw))
    out, lse = fa.blocksparse_attention_ref(q, k, v, act, **kw)
    return (out, lse, *fa.blocksparse_attention_bwd_ref(q, k, v, out, lse, dout, act, **kw))


def _bs_check(act, kw, q, k, v, dout, empty_block=None):
    """The kernels (a forward and a backward launch) against the f32 plain
    reference: f32 within F32_ATOL, bf16 within 2x the bf16 plain version;
    the LSE of live rows close, dead rows at NEG_INF in both."""
    _build.reset_launches()
    kernel = _bs_paths(act, kw, q, k, v, dout, True)
    counts = _build.launch_counts()
    assert [counts[n] for n in ("blocksparse_fwd", "blocksparse_bwd")] == [1, 1]
    ref = _bs_paths(act, kw, q.float(), k.float(), v.float(), dout.float(), False)
    out, lse = kernel[:2]
    if empty_block is not None:
        rows = slice(empty_block * kw["block_q"], (empty_block + 1) * kw["block_q"])
        assert (out[:, rows] == 0).all()
        assert (lse[:, :, rows] == fa.NEG_INF).all()
    live = lse > fa.NEG_INF / 2
    assert torch.equal(live, ref[1] > fa.NEG_INF / 2)
    assert torch.allclose(lse[live], ref[1][live], rtol=1e-5, atol=1e-4)
    names = ("out", "lse", "dq", "dk", "dv")
    if q.dtype == torch.float32:
        for name, a, want in zip(names, kernel, ref):
            if name != "lse":
                _f32_close(a, want)
        return
    plain = _bs_paths(act, kw, q, k, v, dout, False)
    for name, a, p, want in zip(names, kernel, plain, ref):
        if name != "lse":
            _within_2x(a, p, want)


@pytest.mark.parametrize("dt,b,sq,sk,h,block,causal,mask", [
    (torch.bfloat16, 2, 384, 384, 3, 128, True, "band"),
    (torch.bfloat16, 1, 200, 330, 2, 128, False, "random"),   # sq != sk
    (torch.float32, 2, 384, 384, 3, 128, True, "random"),
    (torch.float32, 1, 130, 260, 2, 64, False, "band"),
])
def test_blocksparse_kernels(gen, dt, b, sq, sk, h, block, causal, mask):
    """K9 forward (out, LSE) and its backward (one C entry) against the
    plain versions; query block 1 has no active tile (zero out, NEG_INF
    LSE); each backward takes its own path's forward."""
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    q = (r(b, sq, h, 64) * 0.125).to(dt)            # pre-scaled, as the op does
    k, v, dout = r(b, sk, h, 64).to(dt), r(b, sk, h, 64).to(dt), r(b, sq, h, 64).to(dt)
    n_qb, n_kb = -(-sq // block), -(-sk // block)
    bm = (_band_mask(n_qb, n_kb, 2) if mask == "band" else
          (torch.rand(n_qb, n_kb, generator=torch.Generator().manual_seed(3)) < 0.6).int())
    bm[1] = 0
    act = fa.blocksparse_active(bm.cuda(), causal, block, block)
    _bs_check(act, dict(causal=causal, block_q=block, block_k=block), q, k, v, dout, 1)


@pytest.mark.parametrize("sq,sk,block_q,block_k", [
    (320, 200, 128, 64),     # more queries than keys; the key tile 64 (block_k)
    (200, 320, 64, 128),     # fewer; 128-key tiles
    (1100, 900, 256, 256),   # 128-row forward tiles, 64-key backward tiles
])
def test_blocksparse_bf16_causal_sq_ne_sk(gen, sq, sk, block_q, block_k):
    """The bf16 single-pass backward (K5's kernels over K9's column walk)
    with sq != sk and causal masking (key <= query), unequal blocks, a
    random mask."""
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
    q = (r(2, sq, 2, 64).float() * 0.125).to(torch.bfloat16)
    k, v, dout = r(2, sk, 2, 64), r(2, sk, 2, 64), r(2, sq, 2, 64)
    n_qb, n_kb = -(-sq // block_q), -(-sk // block_k)
    bm = (torch.rand(n_qb, n_kb, generator=torch.Generator().manual_seed(4)) < 0.7).int()
    act = fa.blocksparse_active(bm.cuda(), True, block_q, block_k)
    _bs_check(act, dict(causal=True, block_q=block_q, block_k=block_k), q, k, v, dout)


@pytest.mark.parametrize("causal,sq,sk,block_q,block_k", [
    (True, 4096, 4096, 256, 256),    # chip_smoke's band shape: 128-row tiles
    (False, 200, 330, 128, 64),
    (True, 1300, 900, 128, 128),
    (False, 128, 33280, 64, 64),     # 520 blocks a row
])
def test_blocksparse_table_kernels_match_plain(gen, causal, sq, sk, block_q, block_k):
    """The tables the forward's C entry builds from an int32 blockmask (the
    causal pre-filter applied there) equal the plain version's over the
    active tiles, bit for bit: the lists with the inactive blocks after
    the active ones, the counts and both launch orders."""
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = r(1, sq, 1, 64), r(1, sk, 1, 64), r(1, sk, 1, 64)
    n_qb, n_kb = -(-sq // block_q), -(-sk // block_k)
    bm = (torch.rand(n_qb, n_kb, generator=torch.Generator().manual_seed(6)) < 0.5).int().cuda()
    kw = dict(causal=causal, block_q=block_q, block_k=block_k)
    built = fa._bs_fwd_kernel(q, k, v, bm, **kw)[2]
    plain = fa._bs_tables(fa.blocksparse_active(bm, **kw), sq, sk, **kw)
    assert (built.rows, built.key_tile) == (plain.rows, plain.key_tile)
    for name, a, want in zip(fa.BsTables._fields, built, plain):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, want), name


@pytest.mark.parametrize("sq,sk", [(128, 33280), (33280, 128)])
def test_blocksparse_past_the_old_512_block_cap(gen, sq, sk):
    """Block 64 over 33,280 keys (520 key blocks a row: the forward's
    list) or queries (520 query blocks a column: the backward's), where
    the old kernels refused more than 512; non-causal, a random mask;
    bf16 under the 2x rule against the plain version."""
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
    q = (r(1, sq, 2, 64).float() * 0.125).to(torch.bfloat16)
    k, v, dout = r(1, sk, 2, 64), r(1, sk, 2, 64), r(1, sq, 2, 64)
    n_qb, n_kb = -(-sq // 64), -(-sk // 64)
    assert max(n_qb, n_kb) == 520
    bm = (torch.rand(n_qb, n_kb, generator=torch.Generator().manual_seed(5)) < 0.5).int()
    act = fa.blocksparse_active(bm.cuda(), False, 64, 64)
    _bs_check(act, dict(causal=False, block_q=64, block_k=64), q, k, v, dout)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_blocksparse_ragged_forward(gen, dt):
    """Per-row key lengths (forward only), one of them 0: that row's output
    is 0 and its LSE NEG_INF."""
    b, s, h, block = 3, 320, 2, 64
    r = lambda *sh: torch.randn(*sh, generator=gen, device="cuda").to(dt)
    q, k, v = r(b, s, h, 64), r(b, s, h, 64), r(b, s, h, 64)
    lens = torch.tensor([0, 130, 320], device="cuda")
    bm = _band_mask(5, 5, 3).cuda()
    kw = dict(causal=True, softmax_scale=0.125, block_q=block, block_k=block,
              seq_lengths=lens)
    before = _build.KERNELS["blocksparse_fwd"].launches
    out = fa.flash_blocksparse_attention(q, k, v, bm, **kw)
    assert _build.KERNELS["blocksparse_fwd"].launches == before + 1
    with _build.plain_path():
        ref = fa.flash_blocksparse_attention(q.float(), k.float(), v.float(),
                                             bm, **kw)
        plain = fa.flash_blocksparse_attention(q, k, v, bm, **kw)
    # the LSE from K9's forward and its plain version, over the pre-scaled q
    act = fa.blocksparse_active(bm, True, block, block)
    qs = (q.float() * 0.125).to(dt)
    lkw = dict(causal=True, block_q=block, block_k=block, seq_lengths=lens)
    lse = fa._bs_fwd_kernel(qs, k, v, act, **lkw)[1]
    rlse = fa.blocksparse_attention_ref(qs.float(), k.float(), v.float(), act,
                                        **lkw)[1]
    assert (out[0] == 0).all() and (lse[0] == fa.NEG_INF).all()
    assert torch.allclose(lse[1:], rlse[1:], rtol=1e-5, atol=1e-4)
    if dt == torch.float32:
        _f32_close(out, ref)
    else:
        _within_2x(out, plain, ref)


def test_blocksparse_autograd_launches_k9(gen):
    x = torch.randn(2, 256, 3, 2, 64, generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_(True)
    bm = _band_mask(2, 2, 1).cuda()
    _build.reset_launches()
    out = fa.flash_blocksparse_attention(x[:, :, 0], x[:, :, 1], x[:, :, 2],
                                         bm, block_q=128, block_k=128)
    out.float().square().sum().backward()
    counts = _build.launch_counts()
    assert [counts[n] for n in ("blocksparse_fwd", "blocksparse_bwd")] == [1, 1]
    assert counts["flash_attention"] == counts["flash_attention_bwd"] == 0
    assert torch.isfinite(x.grad.float()).all()


def test_cuda_tensors_never_take_k7_k9_plain_paths(gen, monkeypatch):
    """With the plain versions replaced by a trap, the wrappers still run on
    CUDA tensors (kernels only), and a shape the kernels refuse raises
    instead of falling back."""
    from backpacks_flash_attn_tpu_torch.ops import fused_mlp as fm

    def trap(*a, **kw):
        raise AssertionError("a CUDA tensor took the plain path")

    for mod, name in ((fm, "mlp_fwd_fused_ref"),
                      (fa, "blocksparse_attention_ref"),
                      (fa, "blocksparse_attention_bwd_ref")):
        monkeypatch.setattr(mod, name, trap)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
    fm.mlp_fwd_fused(r(64, 128), r(128, 256), r(256), r(256, 128), r(128))
    x = r(1, 128, 3, 2, 64).requires_grad_(True)
    bm = torch.ones(1, 1, dtype=torch.int32, device="cuda")
    fa.flash_blocksparse_attention(x[:, :, 0], x[:, :, 1], x[:, :, 2], bm,
                                   block_q=128, block_k=128).sum().backward()
    fa.flash_blocksparse_attention(x[:, :, 0], x[:, :, 1], x[:, :, 2], bm,
                                   block_q=128, block_k=128,
                                   seq_lengths=torch.tensor([77], device="cuda"))
    with pytest.raises(ValueError, match="multiples"):
        fm.mlp_fwd_fused(r(8, 96), r(96, 256), r(256), r(256, 96), r(96))
    with pytest.raises(ValueError, match="ROADMAP Queue 2 item 2"):
        y = r(1, 128, 2, 192)
        fa.flash_blocksparse_attention(y, y, y, bm, block_q=128, block_k=128)


# ---- head dims past 64: K3, K5 and K9 at each instance (80, 96, 128) in
# bf16 and f32, rows 16-byte aligned and not, and padded head dims (48 and
# 112 run the 64 and 128 instances over zero columns)

HEAD_DIM_CASES = ([(d, dt, layout) for d in (80, 96, 128) for dt in (BF16, F32)
                   for layout in ("aligned", "misaligned")]
                  + [(48, BF16, "aligned"), (112, BF16, "aligned"), (112, F32, "misaligned")])


def _rows(gen, dt, layout, *shape):
    """randn of shape in dt, as a view whose rows start 16 bytes off (the
    SIMT route of bf16) when misaligned."""
    off = 1 if layout == "misaligned" else 0
    x = torch.randn(*shape[:-1], shape[-1] + off, generator=gen, device="cuda").to(dt)
    return x[..., off:]


@pytest.mark.parametrize("d,dt,layout", HEAD_DIM_CASES)
def test_flash_attention_head_dims(gen, d, dt, layout):
    """K3 at head dim d: ragged lengths and offsets (one empty sequence),
    causal, sq 150 over sk 190, and dropout on an equal-length causal
    call; one launch each; out and LSE against the f32 plain version."""
    from backpacks_flash_attn_tpu_torch.utils import prng
    b, sq, sk, h = 3, 150, 190, 2
    q = _rows(gen, dt, layout, b, sq, h, d)
    k, v = _rows(gen, dt, layout, b, sk, h, d), _rows(gen, dt, layout, b, sk, h, d)
    if layout == "misaligned" and dt == BF16:
        assert not any(_build.aligned16(t) for t in (q, k, v))
    seed = prng.seed_words(prng.PRNGKey(3))
    calls = [(q, k, v, dict(causal=True, softmax_scale=d ** -0.5,
                            seq_lengths=torch.tensor([190, 101, 0], device="cuda"),
                            q_offsets=torch.tensor([40, 0, 7], device="cuda"))),
             (q, k[:, :sq], v[:, :sq], dict(causal=True, softmax_scale=d ** -0.5,
                                            dropout_p=0.1))]
    for q_, k_, v_, kw in calls:
        extra = dict(dropout_rng=prng.PRNGKey(3)) if "dropout_p" in kw else {}
        ref_kw = dict(kw, seed=seed) if extra else kw
        before = _build.KERNELS["flash_attention"].launches
        out, lse = fa.flash_attention(q_, k_, v_, return_lse=True, **kw, **extra)
        assert _build.KERNELS["flash_attention"].launches == before + 1
        assert out.shape == q_.shape
        ref, rlse = fa.flash_attention_ref(q_.float(), k_.float(), v_.float(),
                                           return_lse=True, **ref_kw)
        assert torch.allclose(lse, rlse, rtol=1e-5, atol=1e-4)
        if dt == F32:
            _f32_close(out, ref)
        else:
            _within_2x(out, fa.flash_attention_ref(q_, k_, v_, **ref_kw), ref)


@pytest.mark.parametrize("key_tile", [None, 64])
@pytest.mark.parametrize("d,dt,layout", HEAD_DIM_CASES)
def test_flash_attention_bwd_head_dims(gen, monkeypatch, d, dt, layout, key_tile):
    """K5 at head dim d (q, k and v strided views of one packed tensor,
    causal, dropout 0.1, each backward from its own path's forward): one
    launch; dq, dk, dv against the f32 plain version. key_tile 64 forces
    the 4-warp instance (K9's at 64-key blocks)."""
    if key_tile is not None:
        if dt == F32:
            pytest.skip("the key tile is the bf16 kernel's")
        monkeypatch.setattr(fa, "_k5_key_tile", lambda *a: key_tile)
    b, s, h = 2, 200, 2
    qkv = _rows(gen, F32, layout, b, s, 3, h, d)
    dout = torch.randn(b, s, h, d, generator=gen, device="cuda")
    kw = dict(causal=True, softmax_scale=d ** -0.5, dropout_p=0.1, seed=(12345, 678))

    def grads(x, go, bwd, fwd_kernel=False):
        q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
        if fwd_kernel:
            out, lse = fa._flash_fwd_kernel(q, k, v, scale=kw["softmax_scale"],
                                            seq_lengths=None, q_offsets=None, causal=True,
                                            dropout_p=0.1, seed=kw["seed"])
        else:
            out, lse = fa.flash_attention_ref(q, k, v, return_lse=True, **kw)
        return bwd(q, k, v, out, lse, go, **kw)

    x = qkv.to(dt) if layout == "aligned" else _rows(gen, dt, layout, b, s, 3, h, d)
    if layout == "misaligned":
        x.copy_(qkv.to(dt))
    before = _build.KERNELS["flash_attention_bwd"].launches
    kernel = grads(x, dout.to(dt), fa.flash_attention_bwd, fwd_kernel=True)
    assert _build.KERNELS["flash_attention_bwd"].launches == before + 1
    ref = grads(x.float(), dout.to(dt).float(), fa.flash_attention_bwd_ref)
    if dt == F32:
        for a, r in zip(kernel, ref):
            assert a.shape == r.shape and a.is_contiguous()
            _f32_close(a, r)
        return
    plain = grads(x, dout.to(dt), fa.flash_attention_bwd_ref)
    for a, p_, r in zip(kernel, plain, ref):
        assert a.dtype == dt and a.shape == r.shape and a.is_contiguous()
        _within_2x(a, p_, r)


@pytest.mark.parametrize("d,dt,layout", HEAD_DIM_CASES)
def test_blocksparse_head_dims(gen, d, dt, layout):
    """K9 forward and backward at head dim d: a band mask over 128-blocks
    (block_q 128, block_k 64: the backward's 4-warp instance), causal,
    query block 1 empty; against the f32 plain versions."""
    b, s, h, bq, bk = 2, 384, 2, 128, 64
    q = (_rows(gen, dt, layout, b, s, h, d).float() * d ** -0.5).to(dt)
    k, v = _rows(gen, dt, layout, b, s, h, d), _rows(gen, dt, layout, b, s, h, d)
    dout = _rows(gen, dt, layout, b, s, h, d)
    bm = (torch.rand(3, 6, generator=torch.Generator().manual_seed(5)) < 0.6).int()
    bm[1] = 0
    act = fa.blocksparse_active(bm.cuda(), True, bq, bk)
    _bs_check(act, dict(causal=True, block_q=bq, block_k=bk), q, k, v, dout, 1)


def test_blocksparse_head_dims_op_autograd(gen):
    """The op at gpt3-large's head dim 96 through autograd, bf16 on the
    card's default tiles (128 x 128): one K9 forward and one K9 backward
    launch, finite gradients within the 2x rule of the plain path."""
    x = torch.randn(2, 256, 3, 2, 96, generator=gen, device="cuda").to(BF16)
    bm = _band_mask(2, 2, 1).cuda()

    def grads(y):
        y = y.detach().requires_grad_(True)
        out = fa.flash_blocksparse_attention(y[:, :, 0], y[:, :, 1], y[:, :, 2], bm,
                                             block_q=128, block_k=128)
        out.float().square().sum().backward()
        return y.grad

    _build.reset_launches()
    kernel = grads(x)
    counts = _build.launch_counts()
    assert [counts[n] for n in ("blocksparse_fwd", "blocksparse_bwd")] == [1, 1]
    with _build.plain_path():
        ref, plain = grads(x.float()), grads(x)
    for i in range(3):
        _within_2x(kernel[:, :, i], plain[:, :, i], ref[:, :, i])


@pytest.mark.parametrize("fn", ["k3", "k5", "k9"])
def test_head_dim_past_128_raises_naming_the_roadmap_item(gen, fn):
    """d = 192 has no instance: each kernel wrapper raises, naming ROADMAP
    Queue 2 item 2, and launches nothing."""
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(BF16)
    q = r(1, 64, 2, 192)
    _build.reset_launches()
    with pytest.raises(ValueError, match="ROADMAP Queue 2 item 2"):
        if fn == "k3":
            fa.flash_attention(q, q, q)
        elif fn == "k5":
            lse = torch.zeros(1, 2, 64, device="cuda")
            fa.flash_attention_bwd(q, q, q, q, lse, q)
        else:
            fa.flash_blocksparse_attention(q, q, q, torch.ones(1, 1, dtype=torch.int32,
                                                               device="cuda"),
                                           block_q=128, block_k=128)
    assert not any(_build.launch_counts().values())


def _rotary_gpt():
    """A two-layer rotary GPT at K3's head dim of 64 (fraction 0.5: 32
    rotated channels), no learned positions."""
    from backpacks_flash_attn_tpu_torch.config import GPTConfig
    return GPTConfig(vocab_size=512, n_positions=0, n_embd=128, n_head=2,
                     n_layer=2, rotary_emb_fraction=0.5,
                     pad_vocab_size_multiple=8)


def test_generate_gpt_rotary_launches_k3_and_k1(gen):
    """generate_gpt on a rotary GPT in f32: K3 once a layer for the prefill,
    K1 once a layer a decode step; tokens and scores equal the plain
    path's (f32 sums in another order)."""
    from backpacks_flash_attn_tpu_torch.models import gpt
    from backpacks_flash_attn_tpu_torch.utils.generation import generate_gpt
    cfg = _rotary_gpt()
    params = gpt.init_gpt(cfg, torch.Generator().manual_seed(0), device="cuda")
    params["wte"] *= 20.0
    ids = torch.randint(0, 512, (3, 11), generator=torch.Generator().manual_seed(1)).cuda()
    kw = dict(output_scores=True, cache_dtype=torch.float32)
    _build.reset_launches()
    got = generate_gpt(params, cfg, ids, 20, **kw)
    counts = _build.launch_counts()
    assert counts["flash_attention"] == cfg.n_layer
    assert counts["decode_attention"] == cfg.n_layer * (20 - 11 - 1)
    with _build.plain_path():
        want = generate_gpt(params, cfg, ids, 20, **kw)
    assert torch.equal(got.sequences, want.sequences)
    assert _err(got.scores, want.scores) <= 1e-4 * want.scores.abs().max().item()


def test_rotary_gpt_train_step_launches_k7(gen, monkeypatch):
    """A training step of the rotary GPT with the fused-MLP switch on: K3,
    K5 and K7 once a layer, a finite loss."""
    from backpacks_flash_attn_tpu_torch.models import gpt
    from backpacks_flash_attn_tpu_torch.ops import dense
    from backpacks_flash_attn_tpu_torch.training import train
    from backpacks_flash_attn_tpu_torch.utils import prng
    monkeypatch.setattr(dense, "_FUSED_MLP", True)
    cfg = _rotary_gpt()
    params = train.trainable(gpt.init_gpt(cfg, torch.Generator().manual_seed(0),
                                          dtype=torch.bfloat16, device="cuda"))
    state = train.TrainState(params, train.make_optimizer(params, warmup_steps=1), 0)
    step = train.make_train_step(cfg, model="gpt")
    batch = {"input_ids": torch.randint(0, 512, (2, 65), device="cuda")}
    _build.reset_launches()
    state, m = step(state, batch, prng.PRNGKey(0))
    counts = _build.launch_counts()
    for name in ("flash_attention", "flash_attention_bwd", "fused_mlp_fwd"):
        assert counts[name] == cfg.n_layer, (name, counts)
    assert torch.isfinite(m["loss"])


_REDESIGNS = {
    "gathered": (da.decode_attention_gathered, da.decode_attention_gathered_ref, {}),
    "selector": (da.decode_attention_selector, da.decode_attention_selector_ref,
                 {"v_transposed": False}),
    "selector-vt": (da.decode_attention_selector, da.decode_attention_selector_ref,
                    {"v_transposed": True}),
    "blockdiag": (da.decode_attention_blockdiag, da.decode_attention_blockdiag_ref, {}),
}


def _k1_operands(gen, qdt, kvdt, E, S, dv, pad=16):
    """K1's operands as window slices of caches pad columns wider: q (E, 64)
    pre-scaled, kt (E, 64, S), v (E, S, dv), int8 with (E, S) scales or
    kvdt without."""
    dk, dev = 64, "cuda"
    q = (torch.randn(E, dk, generator=gen, device=dev) * 0.3).to(qdt)
    if kvdt == torch.int8:
        kt = torch.randint(-127, 128, (E, dk, S + pad), generator=gen, device=dev,
                           dtype=torch.int8)
        v = torch.randint(-127, 128, (E, S + pad, dv), generator=gen, device=dev,
                          dtype=torch.int8)
        ks = torch.rand(E, S + pad, generator=gen, device=dev)[:, :S] * 0.02
        vs = torch.rand(E, S + pad, generator=gen, device=dev)[:, :S] * 0.02
    else:
        kt = torch.randn(E, dk, S + pad, generator=gen, device=dev).to(kvdt)
        v = torch.randn(E, S + pad, dv, generator=gen, device=dev).to(kvdt)
        ks = vs = None
    return q, kt[:, :, :S], ks, v[:, :S], vs


@pytest.mark.parametrize("form", list(_REDESIGNS))
@pytest.mark.parametrize("qdt,kvdt,E,S,dv", [
    (torch.float32, torch.float32, 6, 300, 64),
    (torch.float32, torch.int8, 5, 40, 768),
    (torch.bfloat16, torch.int8, 6, 100, 64),
    (torch.bfloat16, torch.bfloat16, 6, 33, 768),
    (torch.bfloat16, torch.int8, 13, 2112, 128),   # odd E, several chunks
    (torch.bfloat16, torch.int8, 6, 100, 60),      # dv not whole 16-byte chunks
    (torch.bfloat16, torch.bfloat16, 4, 65536, 64),  # past the old S cap
])
def test_decode_attention_redesign_kernels(gen, form, qdt, kvdt, E, S, dv):
    """K1-gathered, K1-selector (values transposed by the wrapper, and
    passed transposed) and K1-blockdiag against their plain versions on
    window slices: per-row lengths with an empty row (0 from the gathered
    form, uniform from the others), and a scalar length; each call launches
    its own kernel once and never K1. S 65,536 lies past the warp-a-row
    kernels' cap (a row's scores in shared memory), which the selector and
    blockdiag no longer have."""
    fn, ref_fn, kw = _REDESIGNS[form]
    name = "decode_attention_" + form.split("-")[0]
    q, kt, ks, v, vs = _k1_operands(gen, qdt, kvdt, E, S, dv)
    if kw.get("v_transposed"):      # a window of a wider (E, dv, S + 16) cache
        v = torch.nn.functional.pad(v.transpose(1, 2), (0, 16)).contiguous()[:, :, :S]
    lens = torch.tensor(([0, 1, S // 2, S, 7, 3] * 3)[:E], dtype=torch.int32,
                        device="cuda")
    for length in (lens, 5):
        _build.reset_launches()
        out = fn(q, kt, ks, v, vs, length, **kw)
        counts = _build.launch_counts()
        assert counts[name] == 1 and counts["decode_attention"] == 0, counts
        assert out.shape == (E, dv) and out.dtype == qdt
        ref = ref_fn(q.float(), kt.float(), ks, v.float(), vs, length, **kw)
        if qdt == torch.float32:
            _f32_close(out, ref)
        else:
            _within_2x(out, ref_fn(q, kt, ks, v, vs, length, **kw), ref)
        if form == "gathered" and length is lens:
            assert (out[0] == 0).all()


@pytest.mark.parametrize("form", ["selector", "selector-vt", "blockdiag"])
def test_selector_blockdiag_ignore_rows_per_program(gen, form):
    """rows_per_program is JAX's tiling: 3, 8 and 32 give bit-identical
    output, one launch of the form's own kernel each."""
    fn, _, kw = _REDESIGNS[form]
    name = "decode_attention_" + form.split("-")[0]
    q, kt, ks, v, vs = _k1_operands(gen, torch.bfloat16, torch.int8, 13, 300, 64)
    if kw.get("v_transposed"):
        v = v.transpose(1, 2).contiguous()
    lens = torch.randint(0, 301, (13,), generator=gen, device="cuda", dtype=torch.int32)
    outs = []
    for rows in (3, 8, 32):
        _build.reset_launches()
        outs.append(fn(q, kt, ks, v, vs, lens, rows_per_program=rows, **kw))
        counts = _build.launch_counts()
        assert counts[name] == 1 and counts["decode_attention"] == 0, counts
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("qdt,kvdt,dv", [
    (torch.bfloat16, torch.int8, 61),
    (torch.bfloat16, torch.bfloat16, 1),
    (torch.float32, torch.float32, 130),
])
def test_selector_kernel_any_width(gen, qdt, kvdt, dv):
    """The selector over (E, dv, S) values takes any dv (the last quad of
    channels guarded), as the warp-a-row kernel did: per-row lengths with
    an empty row, against the plain version."""
    E, S = 7, 200
    q, kt, ks, v, vs = _k1_operands(gen, qdt, kvdt, E, S, dv)
    vt = v.transpose(1, 2).contiguous()
    lens = torch.tensor([0, 1, 5, 99, 200, 150, 33], dtype=torch.int32, device="cuda")
    _build.reset_launches()
    out = da.decode_attention_selector(q, kt, ks, vt, vs, lens, v_transposed=True)
    assert _build.launch_counts()["decode_attention_selector"] == 1
    ref = da.decode_attention_selector_ref(q.float(), kt.float(), ks, vt.float(), vs, lens,
                                           v_transposed=True)
    if qdt == torch.float32:
        _f32_close(out, ref)
    else:
        _within_2x(out, da.decode_attention_selector_ref(q, kt, ks, vt, vs, lens,
                                                         v_transposed=True), ref)


def test_gathered_kernel_past_k1s_width(gen):
    """S = 16384: ragged lengths over the whole width, an empty row
    (exactly 0), bf16 over bf16, 2x rule against the f32 plain version; K1
    at the same width."""
    E, S = 12, 16384
    q, kt, ks, v, vs = _k1_operands(gen, torch.bfloat16, torch.bfloat16, E, S, 64)
    lens = torch.randint(1, S + 1, (E,), generator=gen, device="cuda",
                         dtype=torch.int32)
    lens[0], lens[1] = 0, S
    before = _build.KERNELS["decode_attention_gathered"].launches
    out = da.decode_attention_gathered(q, kt, ks, v, vs, lens)
    assert _build.KERNELS["decode_attention_gathered"].launches == before + 1
    assert (out[0] == 0).all()
    ref = da.decode_attention_gathered_ref(q.float(), kt.float(), None, v.float(),
                                           None, lens)
    _within_2x(out, da.decode_attention_gathered_ref(q, kt, None, v, None, lens), ref)
    # K1 takes any S too (it keeps no score row): uniform over S on row 0
    out = da.decode_attention(q, kt, ks, v, vs, lens)
    _within_2x(out, da.decode_attention_ref(q, kt, ks, v, vs, lens),
               da.decode_attention_ref(q.float(), kt.float(), None, v.float(), None, lens))


def _gathered_call(q, kt, ks, v, vs, length, block_s=128):
    """K1-gathered's kernel, checked to launch its own kernel once and K1
    never."""
    _build.reset_launches()
    out = da.decode_attention_gathered(q, kt, ks, v, vs, length, block_s=block_s)
    counts = _build.launch_counts()
    assert counts["decode_attention_gathered"] == 1 and counts["decode_attention"] == 0, counts
    return out


def _gathered_within_2x(out, q, kt, ks, v, vs, length):
    ref = da.decode_attention_gathered_ref(q.float(), kt.float(), ks, v.float(), vs, length)
    _within_2x(out, da.decode_attention_gathered_ref(q, kt, ks, v, vs, length), ref)


@pytest.mark.parametrize("kvdt,S", [(torch.bfloat16, 2112), (torch.int8, 2112),
                                    (torch.bfloat16, 16384), (torch.int8, 16384)])
def test_gathered_balanced_kernel(gen, kvdt, S):
    """K1-gathered's length-balanced launch at gpt-generate's 96 rows (bf16
    over bf16, and over INT8 with scales): ragged lengths with empty rows
    (0, negative) and a row past S (reads S), every row empty (all 0), a
    scalar length, each under the 2x rule against the f32 plain version;
    two calls bit-identical (the merge's fixed order) with a call at 40
    rows between them on the same ticket buffer, left all 0; block_s 64,
    128 and 4096 bit-identical. Each call launches its own kernel once and
    K1 never."""
    E, dev = 96, "cuda"
    elt = 1 if kvdt == torch.int8 else 2
    assert da._gathered_schedule(E, 64, 64, S, elt, _build.sm_count(0)) is not None
    ops = _k1_operands(gen, torch.bfloat16, kvdt, E, S, 64)
    lens = torch.randint(1, S + 1, (E,), generator=gen, device=dev, dtype=torch.int32)
    lens[torch.rand(E, generator=gen, device=dev) < 0.15] = 0
    lens[:4] = torch.tensor([0, S + 100, -3, S], dtype=torch.int32)
    empty = torch.zeros(E, dtype=torch.int32, device=dev)
    for length in (lens, empty, S // 3 + 1):
        out = _gathered_call(*ops, length)
        assert out.shape == (E, 64) and out.dtype == torch.bfloat16
        if length is empty:
            assert (out == 0).all()
            continue
        _gathered_within_2x(out, *ops, length)
        if length is lens:
            assert (out[lens <= 0] == 0).all()
    first = _gathered_call(*ops, lens)
    few = [None if x is None else x[:40] for x in ops]
    _gathered_within_2x(_gathered_call(*few, lens[:40]), *few, lens[:40])
    assert torch.equal(first, _gathered_call(*ops, lens))
    for block_s in (64, 4096):
        assert torch.equal(first, _gathered_call(*ops, lens, block_s))
    torch.cuda.synchronize()
    tickets = da._TICKETS[(0, torch.cuda.current_stream().cuda_stream)]
    assert tickets.numel() >= E and (tickets == 0).all()


def test_gathered_many_rows_take_k1s_launch(gen):
    """Where K1's schedule needs no split (300 rows), K1-gathered launches
    K1's entry under its own count, and its empty rows give 0 (the (m, l)
    epilogue's), not K1's uniform attention; 2x rule against the f32 plain
    version."""
    E, S = 300, 512
    assert da._gathered_schedule(E, 64, 64, S, 1, _build.sm_count(0)) is None
    ops = _k1_operands(gen, torch.bfloat16, torch.int8, E, S, 64)
    lens = torch.randint(0, S + 1, (E,), generator=gen, device="cuda", dtype=torch.int32)
    lens[:3] = torch.tensor([0, S, -1], dtype=torch.int32)
    out = _gathered_call(*ops, lens)
    assert (out[lens <= 0] == 0).all()
    _gathered_within_2x(out, *ops, lens)


@pytest.mark.parametrize("kind", ["int4", "mixed"])
def test_direct_lowbit_entries_kernel(gen, kind):
    """JAX's direct K8 entries: K8 (counted as its key format, not as the
    (m, l) form) with a zero-length row giving exactly 0."""
    E, dk, S2, dv = 6, 64, 96, 64 if kind == "int4" else 768
    dev, name = "cuda", f"lowbit_decode_{kind}"
    q = (torch.randn(E, dk, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
    kshape = (E, dk, 2, S2) if kind == "mixed" else (E, dk, S2)
    keys = torch.randint(-127, 128, kshape, generator=gen, device=dev, dtype=torch.int8)
    v = torch.randint(-128, 128, (E, S2, dv), generator=gen, device=dev, dtype=torch.int8)
    ks = torch.rand(E, 2, S2, generator=gen, device=dev) * (0.05 / (16 if kind == "mixed" else 1))
    vs = torch.rand(E, 2, S2, generator=gen, device=dev) * 0.05
    lens = torch.tensor([0, 1, 2, 77, 2 * S2 - 1, 2 * S2], dtype=torch.int32, device=dev)
    entry = getattr(da, f"decode_attention_{kind}_blockdiag")
    _build.reset_launches()
    out = entry(q, keys, ks, v, vs, lens)
    counts = _build.launch_counts()
    assert counts[name] == 1 and counts["lowbit_decode_int4_ml"] == 0, counts
    assert (out[0] == 0).all()
    with _build.plain_path():
        plain = entry(q, keys, ks, v, vs, lens)
        ref = entry(q.float(), keys, ks, v, vs, lens)
    _within_2x(out, plain, ref)


def _k8_window(gen, qdt, mixed, E, S2, dv, offset, dk=64):
    """K8's operands as window slices of S2 packed columns (``offset`` on)
    of caches 16 columns wider, values ``offset`` x 8 channels into rows 8
    wider: offset 0 keeps every row 16-byte aligned, 1 leaves none aligned
    (the kernel's element copies)."""
    dev = "cuda"
    q = (torch.randn(E, dk, generator=gen, device=dev) * 0.3).to(qdt)
    W, vo = S2 + 16, 8 * min(offset, 1)
    kshape = (E, dk, 2, W) if mixed else (E, dk, W)
    keys = torch.randint(-128, 128, kshape, generator=gen, device=dev, dtype=torch.int8)
    v = torch.randint(-128, 128, (E, W, dv + vo), generator=gen, device=dev, dtype=torch.int8)
    ks, vs = torch.rand(2, E, 2, W, generator=gen, device=dev) * 0.05
    if mixed:
        ks = ks / 16
    cols = slice(offset, offset + S2)
    return q, keys[..., cols], ks[..., cols], v[:, cols, vo:vo + dv], vs[..., cols]


# (label, q dtype, split int8 keys, E, S/2, dv, offset, lengths, dk): the
# redesigned K8's schedules
K8_SCHEDULES = [
    # the GPT rows' 4 rows of 2 warps a CTA, an E off the rows a CTA
    ("rows a CTA", torch.bfloat16, False, 601, 128, 64, 0, "ragged", 64),
    ("rows a CTA mixed", torch.bfloat16, True, 599, 64, 64, 0, "ragged", 64),
    # several tiles a row, unaligned windows (element copies), dv 48 (lanes
    # short of a full quad set), other dk
    ("ring", torch.bfloat16, False, 300, 300, 64, 0, "ragged", 64),
    ("ring unaligned", torch.bfloat16, False, 200, 300, 48, 1, "ragged", 80),
    ("mixed unaligned", torch.bfloat16, True, 150, 257, 64, 1, "ragged", 64),
    ("combine", torch.bfloat16, True, 64, 256, 768, 0, "ragged", 64),
    ("combine int4 unaligned", torch.bfloat16, False, 33, 200, 768, 1, "ragged", 64),
    # few rows: S split over a cluster, short rows among long ones
    ("split short rows", torch.bfloat16, False, 40, 1000, 64, 0, "short", 64),
    ("split mixed wide", torch.bfloat16, True, 9, 700, 768, 0, "short", 64),
    # S past 8192 positions (the old kernel's cap was S/2 4096)
    ("S 12000", torch.bfloat16, False, 12, 6000, 64, 0, "long", 64),
    ("S 12000 mixed", torch.bfloat16, True, 6, 6000, 128, 0, "long", 256),
    # the f32 oracles
    ("f32 rows a CTA", torch.float32, False, 602, 128, 64, 0, "short", 64),
    ("f32 split mixed", torch.float32, True, 10, 1000, 768, 1, "short", 64),
]


# each schedule through the dispatcher, the (m, l) form (int4 keys only,
# as decode_attention_int4_staged_ml takes them) and the direct entries
K8_FORMS = [(form, *case) for case in K8_SCHEDULES
            for form in (("k8", "direct") if case[2] else ("k8", "ml", "direct"))]


@pytest.mark.parametrize("form,label,qdt,mixed,E,S2,dv,offset,lens,dk", K8_FORMS)
def test_lowbit_decode_k8_schedules(gen, form, label, qdt, mixed, E, S2, dv, offset, lens, dk):
    """K8 at each schedule of the redesigned kernel through the dispatcher
    (empty rows uniform over all S positions), the (m, l) form (int4 keys;
    empty rows (0, NEG, 0)) and JAX's direct entries (empty rows 0), per-row
    lengths (odd and even, 0, 1, the whole width) and scalar ones: one
    launch a call of its own counter; f32 within 1e-5 of the f32 plain
    version, bf16 under the 2x rule against it."""
    dev, S = "cuda", 2 * S2
    q, keys, ks, v, vs = _k8_window(gen, qdt, mixed, E, S2, dv, offset, dk)
    if lens == "long":
        rows = torch.randint(S - 129, S + 1, (E,), generator=gen, device=dev, dtype=torch.int32)
    else:
        rows = torch.randint(1, S + 1, (E,), generator=gen, device=dev, dtype=torch.int32)
    rows[0], rows[1] = 0 if lens != "long" else S, 1 if lens == "short" else S - 1
    sched = da._k8_schedule(E, dk, dv, S2, mixed, _build.sm_count(0))
    if label.startswith(("rows a CTA", "f32 rows a CTA")):
        assert sched[1:3] == (8, 4), sched
    if label.startswith(("split", "S 12000", "f32 split")):
        assert sched[3] > 1, sched
    kind = "mixed" if mixed else "int4"
    if form == "ml":
        name, fn, plain = ("lowbit_decode_int4_ml", da.decode_attention_int4_ml,
                           da.decode_attention_flat_int4_ml)
    elif form == "direct":
        name, fn = f"lowbit_decode_{kind}", getattr(da, f"decode_attention_{kind}_blockdiag")

        def plain(*a, fn=fn):
            with _build.plain_path():
                return fn(*a)
    else:
        name, fn = f"lowbit_decode_{kind}", getattr(da, f"decode_attention_{kind}")
        plain = getattr(da, f"decode_attention_flat_{kind}")
    for length in (rows, S - 3, 0):
        before = _build.KERNELS[name].launches
        out = fn(q, keys, ks, v, vs, length)
        assert _build.KERNELS[name].launches == before + 1
        ref = plain(q.float(), keys, ks, v, vs, length)
        empty = (rows <= 0) if length is rows else torch.full_like(rows, length <= 0,
                                                                    dtype=torch.bool)
        if form == "ml":
            assert (out[0][empty] == 0).all() and (out[1][empty] == da.NEG).all()
            assert (out[2][empty] == 0).all()
            if not empty.all():
                _ml_close(out, plain(q, keys, ks, v, vs, length), ref, qdt)
            continue
        if form == "direct":
            assert (out[empty] == 0).all()
            if empty.all():
                continue
        if qdt == torch.float32:
            _f32_close(out, ref)
        else:
            _within_2x(out, plain(q, keys, ks, v, vs, length), ref)


def test_decode_attention_flat_launches_k1(gen):
    q, kt, ks, v, vs = _k1_operands(gen, torch.bfloat16, torch.int8, 4, 512, 64)
    before = _build.KERNELS["decode_attention"].launches
    out = da.decode_attention_flat(q, kt, ks, v, vs, 300, length_buckets=True)
    assert _build.KERNELS["decode_attention"].launches == before + 1
    assert torch.equal(out, da.decode_attention(q, kt, ks, v, vs, 300))


# ------------------------------------------------------------ interventions

def _intervention_setup(seed=0):
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    cfg = _backpack_d64()
    params = bp.init_backpack(cfg, torch.Generator().manual_seed(seed),
                              dtype=torch.bfloat16, device="cuda")
    table = 0.4 + 1.2 * torch.rand(cfg.padded_vocab_size, cfg.num_senses,
                                   generator=torch.Generator().manual_seed(1))
    return cfg, params, table.cuda()


@pytest.mark.parametrize("mode", ["weighted", "negative"])
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.int8])
def test_intervention_decode_steps_on_the_card(gen, mode, cache_dtype):
    """weighted_decode_step / negative_decode_step teacher-forced over a
    prefill and 4 decode steps: the kernel path's logits within twice the
    bf16 plain path's error against the f32 reference (f32 weights; an f32
    cache, or the same INT8 cache); K1 once per GPT layer and once for the
    combine a decode step."""
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    from backpacks_flash_attn_tpu_torch.models import interventions as iv

    cfg, params, table = _intervention_setup()
    p32 = _tree_float(params)
    ids = torch.randint(0, 512, (3, 12), generator=gen, device="cuda")
    paths = {"kernel": (params, cache_dtype), "plain": (params, cache_dtype),
             "ref": (p32, torch.float32 if cache_dtype != torch.int8
                     else torch.int8)}
    runs = {}
    for name, (p, dt) in paths.items():
        cache = bp.init_backpack_cache(cfg, 3, 64, dt, device="cuda")
        state = (iv.init_weighted_decode_state(cfg, 3, 64, device="cuda")
                 if mode == "weighted" else
                 iv.init_negative_decode_state(cfg, 3, 64, quantile=0.05,
                                               device="cuda"))
        runs[name] = [p, cache, state]
    step = (iv.weighted_decode_step if mode == "weighted" else
            lambda *a, **k: iv.negative_decode_step(*a, quantile=0.05, **k))
    errs = {"kernel": 0.0, "plain": 0.0}
    for i in range(5):
        outs = {}
        for name, run in runs.items():
            ctx = (_build.plain_path() if name != "kernel"
                   else contextlib.nullcontext())
            before = _build.KERNELS["decode_attention"].launches
            with ctx:
                logits, run[1], run[2] = step(run[0], cfg, ids, run[1], run[2],
                                              table, anneal=True)
            if name == "kernel" and i:
                assert (_build.KERNELS["decode_attention"].launches - before
                        == cfg.n_layer + 1)
            outs[name] = logits.float()
        for name in errs:
            errs[name] = max(errs[name], _err(outs[name], outs["ref"]))
        ids = outs["kernel"][:, -1].argmax(-1)[:, None]
    assert errs["plain"] > 0 and errs["kernel"] <= 2 * errs["plain"], errs


def test_weighted_forward_k4_on_the_card(gen):
    """weighted_forward and replaced_word_forward through K3 and K4 (one K4
    launch a forward) against their einsum route, under the 2x rule of the
    f32 reference."""
    from backpacks_flash_attn_tpu_torch.models import interventions as iv

    cfg, params, table = _intervention_setup()
    p32 = _tree_float(params)
    ids = torch.randint(0, 512, (2, 96), generator=gen, device="cuda")
    edit = iv.mogrify_word(params, cfg, int(ids[0, 5]), 7, 9)
    forwards = {
        "weighted": lambda p, **kw: iv.weighted_forward(p, cfg, ids, table, **kw),
        "replaced": lambda p, **kw: iv.replaced_word_forward(p, cfg, ids, *edit,
                                                             **kw)}
    for name, fwd in forwards.items():
        before = _build.KERNELS["fused_contextualization"].launches
        out = fwd(params)
        assert _build.KERNELS["fused_contextualization"].launches == before + 1
        with _build.plain_path():
            plain = fwd(params, fused_ctx=False)
            ref = fwd(p32, fused_ctx=False)
        _within_2x(out, plain, ref)


def test_serving_engine_interventions_on_the_card(gen):
    """A short mixed run (a control, a negative and a plain request over 3
    slots, then three plain ones; INT8 caches, a 4-column stage): a step
    with an intervention slot active launches plain K1 once per GPT layer
    and once for the combine, and its (m, l) form never; the plain steps
    the reverse."""
    from backpacks_flash_attn_tpu_torch.serving.engine import ServingEngine

    cfg, params, table = _intervention_setup()
    rng = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, 512, (n,), generator=rng).tolist()
               for n in (3, 9, 17, 5, 12, 7)]
    modes = [dict(control=True), dict(negative=True), {}, {}, {}, {}]
    eng = ServingEngine(params, cfg, max_slots=3, max_seqlen=64,
                        cache_dtype=torch.int8, eos_id=-1, stage_tokens=4,
                        control_table=table, negative_table=table,
                        negative_quantile=0.05)
    _build.reset_launches()
    rids = [eng.submit(p, max_new_tokens=9, **kw) for p, kw in zip(prompts, modes)]
    res = eng.run()
    counts, stats = _build.launch_counts(), eng.stats()
    steps, iv_steps = stats["decode_steps"], stats["intervention_steps"]
    assert all(len(res[r].tokens) == 9 for r in rids) and 0 < iv_steps < steps
    assert counts["decode_attention"] == (cfg.n_layer + 1) * iv_steps
    assert counts["decode_attention_ml"] == (cfg.n_layer + 1) * (steps - iv_steps)
    assert stats["completed"] == len(prompts)


def _tree_float(tree):
    if isinstance(tree, dict):
        return {k: _tree_float(v) for k, v in tree.items()}
    return tree.float()
