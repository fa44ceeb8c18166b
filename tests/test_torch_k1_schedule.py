"""K1's launch schedule (``ops/decode_attention.py`` ``_k1_schedule``) and
the order in which its kernel splits and merges a row, on the CPU: no JAX
and no card needed.

The C entry takes the schedule as the wrapper gives it. The kernel's loops
(``csrc/decode_attention.cu``) are written out in ``_streams`` and
``_emulate``: a row of n valid positions (S for an empty K1 row, which
attends uniformly; 0 for an empty row of the (m, l) form) is cut into
group tiles of Tg = wr x Tw positions; CTA ``rank`` of the row's cluster
takes the contiguous run of group tiles [rank * tc, (rank + 1) * tc), tc =
ceil(tiles / split), and its warp ``wi`` positions [wi Tw, (wi + 1) Tw) of
each; each warp keeps an online softmax (m, l, acc) over its slices, and
the row's partials merge in (rank, warp) order. The checks: every model
shape gives every SM of 132-, 114- and 78-SM cards a CTA and fits two CTAs
an SM; the split covers a row's valid positions exactly once for every
length at gpt-generate's shape; and the emulated split and merge equal the
plain versions in f32, empty rows included.
"""

import math

import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu_torch.ops import decode_attention as da

SMS = (132, 114, 78)
# (label, E, dk, dv, S, element bytes): the shapes K1 and K1-ml launch at
# on the model paths (backpack-small at batch 128: 12 GPT heads, 16 senses;
# the serve's 512 cache, the engine's 256 window; gpt-generate: batch 8 x
# 12 heads over 2048 + 64 positions)
MODEL_SHAPES = [
    ("gpt int8", 1536, 64, 64, 512, 1),
    ("gpt bf16", 1536, 64, 64, 512, 2),
    ("combine int8", 2048, 64, 768, 512, 1),
    ("combine bf16", 2048, 64, 768, 512, 2),
    ("gpt-generate", 96, 64, 64, 2112, 2),
    ("gpt int8 window 256", 1536, 64, 64, 256, 1),
    ("combine int8 window 256", 2048, 64, 768, 256, 1),
]


def _streams(n, tw, wr, split):
    """(rank, warp, [(start, stop) of its slice of each group tile]) of
    every warp of a row of n positions, slices in the warp's order."""
    tg = wr * tw
    nt = -(-n // tg)
    tc = -(-nt // split)
    for rank in range(split):
        for wi in range(wr):
            slices = []
            for t in range(rank * tc, min(nt, (rank + 1) * tc)):
                lo = t * tg + wi * tw
                if lo < n:
                    slices.append((lo, min(n, lo + tw)))
            yield rank, wi, slices


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("label,E,dk,dv,S,elt", MODEL_SHAPES)
def test_k1_schedule_fills_the_card(label, E, dk, dv, S, elt, sms):
    qpl, warps, rows, split, stages = da._k1_schedule(E, dk, dv, S, elt, sms)
    assert qpl in (1, 2, 4, 6, 8) and 4 * 32 * qpl >= dv
    assert warps % rows == 0 and 1 <= split <= 8 and split & (split - 1) == 0
    assert -(-E // rows) * split >= sms, (label, rows, split)
    wr = warps // rows
    tg = wr * da._k1_warp_tile(qpl, elt)
    assert wr & (wr - 1) == 0 and tg * elt % 16 == 0
    if dv <= 128:
        assert tg * elt >= 128                         # a key row read in 128-byte runs
    assert 2 * split <= -(-S // tg)                    # two group tiles a CTA at full width
    if dv <= 128 and E >= 2 * sms:
        assert rows >= 2                               # several narrow rows a CTA
    # two CTAs an SM (the card reserves 1 KB a CTA of its 228 KB)
    smem = rows * da._k1_group_bytes(qpl, dk, dv, elt, wr, stages)
    assert 2 <= stages <= 4 and 2 * (smem + 1024) <= 233472


def test_k1_schedule_splits_only_few_rows():
    assert da._k1_schedule(96, 64, 64, 2112, 2, 132) == (1, 8, 1, 2, 3)
    assert da._k1_schedule(1536, 64, 64, 512, 1, 132)[3] == 1
    assert da._k1_schedule(2048, 64, 768, 512, 1, 132)[3] == 1
    # few rows over a short cache (one group tile): no split
    assert da._k1_schedule(4, 64, 64, 100, 1, 132)[3] == 1


@pytest.mark.parametrize("dk", [1, 64, 256])
@pytest.mark.parametrize("dv", [4, 64, 100, 128, 132, 768, 1024])
@pytest.mark.parametrize("elt", [1, 2, 4])
def test_k1_schedule_fits_a_block(dk, dv, elt):
    """Every operand the wrapper takes (dk <= 256, dv <= 1024) fits a CTA's
    227 KB of shared memory, in key rows of whole 16-byte chunks."""
    for e, s in ((1, 1), (96, 2112), (5000, 16384)):
        qpl, warps, rows, split, stages = da._k1_schedule(e, dk, dv, s, elt, 132)
        wr = warps // rows
        assert wr * da._k1_warp_tile(qpl, elt) * elt % 16 == 0
        assert rows * da._k1_group_bytes(qpl, dk, dv, elt, wr, stages) <= 232448


def test_k1_split_chunks_cover_each_row_once():
    """gpt-generate's shape: for every row length the warp streams of the
    split cover the row's valid positions [0, n) exactly once (the whole
    width [0, S) for an empty K1 row), each CTA a contiguous run starting
    at the end of the previous CTA's, and no cluster above 8 CTAs."""
    S = 2112
    qpl, warps, rows, split, _ = da._k1_schedule(96, 64, 64, S, 2, 132)
    tw, wr = da._k1_warp_tile(qpl, 2), warps // rows
    assert split > 1 and split <= 8
    for n in range(S + 1):
        seen = np.zeros(S, np.int64)
        by_rank = {}
        for rank, _, slices in _streams(n, tw, wr, split):
            for lo, hi in slices:
                seen[lo:hi] += 1
                a, b = by_rank.get(rank, (lo, hi))
                by_rank[rank] = (min(a, lo), max(b, hi))
        assert (seen[:n] == 1).all() and (seen[n:] == 0).all(), n
        nxt = 0
        for rank in sorted(by_rank):
            lo, hi = by_rank[rank]
            assert lo == nxt, (n, rank)
            nxt = hi


def _emulate(q, kt, ks, v, vs, length, *, ml, tw, wr, split):
    """The kernel's split and merge in plain f32 torch: per warp stream an
    online softmax over its tiles in order, then the row's partials merged
    in (rank, warp) order. -> out, or (out, m, l) with ``ml``."""
    e, s_len, dv = q.shape[0], v.shape[1], v.shape[2]
    lens = da._row_lengths(length, e, q.device).tolist()
    out = torch.zeros(e, dv)
    m_out = torch.zeros(e, 1)
    l_out = torch.zeros(e, 1)
    ninf = torch.tensor(-math.inf)
    for r in range(e):
        empty = lens[r] <= 0
        n = (0 if ml else s_len) if empty else min(lens[r], s_len)
        parts = []
        for _, _, slices in _streams(n, tw, wr, split):
            m, l, acc = ninf, torch.tensor(0.0), torch.zeros(dv)
            for lo, hi in slices:
                pos = slice(lo, hi)
                if empty:
                    sc = torch.zeros(pos.stop - pos.start)
                else:
                    sc = q[r] @ kt[r, :, pos]
                    if ks is not None:
                        sc = sc * ks[r, pos]
                m_new = torch.maximum(m, sc.max())
                alpha = torch.exp(m - m_new)
                p = torch.exp(sc - m_new)
                l = l * alpha + p.sum()
                w = p * vs[r, pos] if vs is not None else p
                acc = acc * alpha + w @ v[r, pos]
                m = m_new
            parts.append((m, l, acc))
        big = max((pm for pm, _, _ in parts), default=ninf)
        lsum, o = torch.tensor(0.0), torch.zeros(dv)
        for pm, pl, pa in parts:
            w = torch.tensor(0.0) if pm == -math.inf else torch.exp(pm - big)
            lsum = lsum + pl * w
            o = o + pa * w
        out[r] = o / lsum if lsum > 0 else 0.0
        m_out[r] = big if lsum > 0 else da.NEG
        l_out[r] = lsum
    return (out, m_out, l_out) if ml else out


def _problem(rng, e, dk, dv, s, quant):
    q = torch.from_numpy(rng.normal(size=(e, dk)).astype(np.float32) * 0.3)
    if quant:
        kt = torch.from_numpy(rng.integers(-127, 128, (e, dk, s)).astype(np.float32))
        v = torch.from_numpy(rng.integers(-127, 128, (e, s, dv)).astype(np.float32))
        ks, vs = torch.from_numpy(rng.uniform(0.001, 0.02, (2, e, s)).astype(np.float32))
    else:
        kt = torch.from_numpy(rng.normal(size=(e, dk, s)).astype(np.float32))
        v = torch.from_numpy(rng.normal(size=(e, s, dv)).astype(np.float32))
        ks = vs = None
    return q, kt, ks, v, vs


@pytest.mark.parametrize("ml", [False, True])
@pytest.mark.parametrize("quant,dv,tw,wr,split", [
    (True, 64, 32, 1, 1),       # narrow int8: a warp a row
    (True, 64, 32, 4, 1),       # the GPT rows: four warps a row
    (False, 64, 16, 8, 2),      # gpt-generate's schedule: a cluster of 2
    (False, 64, 16, 8, 8),      # the largest cluster
    (True, 768, 8, 4, 4),       # wide rows under a split
    (True, 96, 32, 2, 3),       # a cluster off a power of two
])
def test_k1_split_merge_matches_plain(ml, quant, dv, tw, wr, split):
    """The emulated kernel equals decode_attention_ref (out) and
    decode_attention_ml_ref (out, m, l) in f32 within 1e-6 of the output's
    scale: per-row lengths with empty rows (uniform over S in K1, (0, NEG,
    0) in the (m, l) form), rows of one position and of the whole width, a
    row shorter than a tile under the split; and a scalar length."""
    rng = np.random.default_rng(11 + dv + split)
    e, dk, s = 7, 64, 300
    q, kt, ks, v, vs = _problem(rng, e, dk, dv, s, quant)
    lens = torch.tensor([0, 1, 5, 150, s, 299, -3], dtype=torch.int32)
    for length in (lens, 77, 0):
        got = _emulate(q, kt, ks, v, vs, length, ml=ml, tw=tw, wr=wr, split=split)
        ref_fn = da.decode_attention_ml_ref if ml else da.decode_attention_ref
        want = ref_fn(q, kt, ks, v, vs, length)
        for g, w in zip(*((got, want) if ml else ((got,), (want,)))):
            tol = 1e-6 * max(1.0, w.abs().max().item())
            assert (g - w).abs().max().item() <= tol, (length, (g - w).abs().max())
        if ml and not isinstance(length, int):
            out, m, l = got
            assert (out[0] == 0).all() and m[0, 0] == da.NEG and l[0, 0] == 0
