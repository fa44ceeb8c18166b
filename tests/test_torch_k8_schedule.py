"""K8's launch schedule (``ops/decode_attention.py`` ``_k8_schedule``) and the
order in which its kernel streams, scores and merges a row, on the CPU: no
JAX and no card needed.

K8 runs K1's kernel body (``csrc/decode_attention.cuh``) over the low-bit
layouts: a column is a packed column holding positions 2j (low nibble) and
2j + 1 (high nibble). The kernel's loops are written out in ``_emulate``: a
row of lenp valid positions (2 S/2 for an empty row of the dispatcher,
which attends uniformly; 0 for an empty row of the (m, l) form and of the
direct entries) has n = ceil(lenp / 2) valid columns, cut into group tiles
of Tg = wr x Tw columns; CTA ``rank`` of the row's cluster takes a
contiguous run of group tiles and its warp ``wi`` columns [wi Tw, (wi + 1)
Tw) of each; each warp scores both positions of its columns (the odd one
masked where 2j + 1 >= lenp), keeps one online softmax over both parities
and the row's partials merge in (rank, warp) order. The emulation also
takes the nibbles as the kernel does, each plus the offset 136 (the
__byte_perm decode, ``_nib8``), with the offset taken off the score and
value sums. The checks: the emulated kernel equals the plain versions in
f32 for int4 and split int8 keys, odd and even lengths, the three
semantics of an empty row and S/2 past the old cap of 4096; the schedule
fills 132-, 114- and 78-SM cards at the model shapes and fits a block's
shared memory.
"""

import math

import numpy as np
import pytest
import torch

from backpacks_flash_attn_tpu_torch.ops import decode_attention as da
from backpacks_flash_attn_tpu_torch.ops import quant

SMS = (132, 114, 78)
NIB_OFF = 136.0
# (label, E, dk, dv, S/2, split int8 keys): the shapes K8 and K8-ml launch
# at (backpack-small at batch 128: 12 GPT heads, 16 senses; the serve's
# 512 cache under its 128 and 256 windows; chip_smoke's S 16384 case past
# the old cap at gpt-generate's 96 rows) and the direct entries'
# decode-kernels shapes (int4 keys at the combine too)
MODEL_SHAPES = [
    ("gpt int4 window 128", 1536, 64, 64, 64, False),
    ("gpt int4 window 256", 1536, 64, 64, 128, False),
    ("gpt int4 S 512", 1536, 64, 64, 256, False),
    ("combine mixed window 128", 2048, 64, 768, 64, True),
    ("combine mixed S 512", 2048, 64, 768, 256, True),
    ("combine int4 S 512", 2048, 64, 768, 256, False),
    ("gpt mixed S 256", 1536, 64, 64, 128, True),
    ("long int4 S 16384", 96, 64, 64, 8192, False),
]


def _byte_perm(x, y, s):
    """CUDA's __byte_perm: byte n of the result is byte (s >> 4n) & 7 of
    the eight bytes of (y, x)."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(s >> (4 * n)) & 7] << (8 * n) for n in range(4))


def _nib8(w):
    """The kernel's nib8: a word's 8 nibbles as f32 plus 136 -> (lo, hi),
    byte i's low and high nibble."""
    lo_w = (w & 0x0F0F0F0F) ^ 0x08080808
    hi_w = ((w >> 4) & 0x0F0F0F0F) ^ 0x08080808
    as_f32 = lambda u: float(np.array([u], np.uint32).view(np.float32)[0])
    return ([as_f32(_byte_perm(lo_w, 0x43000000, 0x7044 + (i << 8))) for i in range(4)],
            [as_f32(_byte_perm(hi_w, 0x43000000, 0x7044 + (i << 8))) for i in range(4)])


def test_nib8_decodes_every_nibble_with_its_offset():
    """Every byte value at every byte of a word: the low and high nibbles
    decode to their sign-extended values plus 136, exactly."""
    rng = np.random.default_rng(0)
    for byte in range(256):
        for pos in range(4):
            other = int(rng.integers(0, 2 ** 32))
            w = (other & ~(0xFF << (8 * pos))) | (byte << (8 * pos))
            lo, hi = _nib8(w)
            sext = lambda n: n - 16 if n >= 8 else n
            assert lo[pos] == NIB_OFF + sext(byte & 0xF), (byte, pos)
            assert hi[pos] == NIB_OFF + sext(byte >> 4), (byte, pos)


def _streams(n, tw, wr, split):
    """(rank, warp, [(start, stop) of its columns in each group tile]) of
    every warp of a row of n valid columns."""
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


def _emulate(q, k_lo, k_hi, ks2, v_lo, v_hi, vs2, length, *, int4, ml, tw, wr, split):
    """The kernel in plain f32 torch: keys k_lo/k_hi (E, dk, S/2) and values
    v_lo/v_hi (E, S/2, dv) as the even and odd halves; int4 ones carry the
    nibble offset as the kernel's decode gives them. -> out, or (out, m, l)
    with ``ml`` (the (m, l) form, whose out is the direct entries')."""
    e, s2, dv = q.shape[0], v_lo.shape[1], v_lo.shape[2]
    lens = da._row_lengths(length, e, q.device).tolist()
    koff = NIB_OFF if int4 else 0.0
    out, m_out, l_out = torch.zeros(e, dv), torch.zeros(e, 1), torch.zeros(e, 1)
    ninf = torch.tensor(-math.inf)
    for r in range(e):
        empty = lens[r] <= 0
        lenp = (0 if ml else 2 * s2) if empty else min(lens[r], 2 * s2)
        n = -(-lenp // 2)
        parts = []
        for _, _, slices in _streams(n, tw, wr, split):
            m, l, acc, wsum = ninf, torch.tensor(0.0), torch.zeros(dv), torch.tensor(0.0)
            for lo, hi in slices:
                cols = torch.arange(lo, hi)
                if empty:
                    sc = torch.zeros(2, hi - lo)
                else:
                    qk = lambda k: q[r] @ (k[r][:, lo:hi] + koff) - koff * q[r].sum()
                    sc = torch.stack([qk(k_lo) * ks2[r, 0, lo:hi], qk(k_hi) * ks2[r, 1, lo:hi]])
                sc[1, 2 * cols + 1 >= lenp] = -math.inf
                m_new = torch.maximum(m, sc.max())
                alpha = torch.exp(m - m_new)
                p = torch.exp(sc - m_new)
                l = l * alpha + p.sum()
                w = p * vs2[r, :, lo:hi]
                wsum = wsum * alpha + w.sum()
                acc = (acc * alpha + w[0] @ (v_lo[r, lo:hi] + NIB_OFF)
                       + w[1] @ (v_hi[r, lo:hi] + NIB_OFF))
                m = m_new
            parts.append((m, l, acc - NIB_OFF * wsum))
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


def _problem(rng, e, dk, dv, s2, mixed):
    """q, the keys as the kernel takes them (kt4 (E, dk, S/2) or k8 (E, dk,
    2, S/2)), ks2, v4, vs2."""
    q = torch.from_numpy(rng.normal(size=(e, dk)).astype(np.float32) * 0.3)
    if mixed:
        keys = torch.from_numpy(rng.integers(-127, 128, (e, dk, 2, s2)).astype(np.int8))
    else:
        keys = quant.pack_int4_pairs(torch.from_numpy(
            rng.integers(-8, 8, (e, dk, 2 * s2)).astype(np.int8)), axis=2)
    v4 = quant.pack_int4_pairs(torch.from_numpy(
        rng.integers(-8, 8, (e, 2 * s2, dv)).astype(np.int8)), axis=1)
    ks2 = torch.from_numpy(rng.uniform(0.001, 0.05 / (16 if mixed else 1),
                                       (e, 2, s2)).astype(np.float32))
    vs2 = torch.from_numpy(rng.uniform(0.001, 0.05, (e, 2, s2)).astype(np.float32))
    return q, keys, ks2, v4, vs2


def _halves(keys, v4, mixed):
    k_lo, k_hi = (keys[:, :, 0], keys[:, :, 1]) if mixed else quant.unpack_int4_pairs_split(keys)
    v_lo, v_hi = quant.unpack_int4_pairs_split(v4)
    return [t.float() for t in (k_lo, k_hi, v_lo, v_hi)]


def _close(got, want):
    for g, w in zip(got, want):
        tol = 1e-5 * max(1.0, w.abs().max().item())
        assert (g - w).abs().max().item() <= tol, (g - w).abs().max()


def test_k8_stream_merge_matches_plain():
    """The emulated kernel against decode_attention_flat_int4 (out),
    decode_attention_flat_int4_ml (out, m, l; its out is the direct
    entries' with an empty row at 0) and decode_attention_flat_mixed, in
    f32 within 1e-5 of the output's scale, at several schedules: per-row
    lengths with empty rows (uniform over all 2 S/2 positions in the
    dispatcher, (0, NEG, 0) in the (m, l) form), odd lengths (the last
    column's odd half masked) and even ones, lengths past the width, rows
    shorter than a tile under a split; and scalar lengths."""
    schedules = [(32, 2, 1), (32, 8, 2), (32, 2, 3), (8, 2, 1), (8, 4, 4)]
    for case, (tw, wr, split) in enumerate(schedules):
        for mixed in (False, True):
            dv = 48 if tw == 32 else 96
            rng = np.random.default_rng(100 + 10 * case + mixed)
            e, dk, s2 = 9, 64, 150
            q, keys, ks2, v4, vs2 = _problem(rng, e, dk, dv, s2, mixed)
            halves = _halves(keys, v4, mixed)
            lens = torch.tensor([0, 1, 2, 3, 77, 150, 299, 300, 412], dtype=torch.int32)
            flat = da.decode_attention_flat_mixed if mixed else da.decode_attention_flat_int4
            for length in (lens, 77, 0):
                got = _emulate(q, halves[0], halves[1], ks2, halves[2], halves[3], vs2,
                               length, int4=not mixed, ml=False, tw=tw, wr=wr, split=split)
                _close((got,), (flat(q, keys, ks2, v4, vs2, length),))
                if mixed:
                    continue
                got = _emulate(q, halves[0], halves[1], ks2, halves[2], halves[3], vs2,
                               length, int4=True, ml=True, tw=tw, wr=wr, split=split)
                want = da.decode_attention_flat_int4_ml(q, keys, ks2, v4, vs2, length)
                _close(got, want)
                if not isinstance(length, int):
                    assert (got[0][0] == 0).all() and got[1][0, 0] == da.NEG and got[2][0, 0] == 0


def test_k8_past_the_old_cap_matches_plain():
    """S/2 = 4500 (past the old kernel's 4096, which kept the score row in
    shared memory): the schedule's split of few rows and the emulated
    stream equal the plain version, int4 and split int8 keys."""
    e, dk, dv, s2 = 3, 64, 64, 4500
    for mixed in (False, True):
        _, warps, rows, split, stages = da._k8_schedule(e, dk, dv, s2, mixed, 132)
        assert split > 1 and stages == 2
        rng = np.random.default_rng(7 + mixed)
        q, keys, ks2, v4, vs2 = _problem(rng, e, dk, dv, s2, mixed)
        halves = _halves(keys, v4, mixed)
        lens = torch.tensor([2 * s2, 8191, 6000], dtype=torch.int32)
        got = _emulate(q, halves[0], halves[1], ks2, halves[2], halves[3], vs2, lens,
                       int4=not mixed, ml=False, tw=_tile(1), wr=warps // rows, split=split)
        flat = da.decode_attention_flat_mixed if mixed else da.decode_attention_flat_int4
        _close((got,), (flat(q, keys, ks2, v4, vs2, lens),))


def _tile(qpl):
    return da._k1_warp_tile(qpl, 1)


def test_k8_schedule_fills_the_card():
    """At every model shape on 132-, 114- and 78-SM cards: every SM gets a
    CTA, a warp takes 32 packed columns of a narrow row and 8 of a wide
    one, rows of 2 warps share a CTA where the rows are many (4 narrow
    ones; 2 wide ones up to 128 packed columns, 1 row of 4 warps past
    that), and two CTAs of a 2-stage ring fit an SM."""
    for label, E, dk, dv, s2, mixed in MODEL_SHAPES:
        for sms in SMS:
            qpl, warps, rows, split, stages = da._k8_schedule(E, dk, dv, s2, mixed, sms)
            where = (label, sms)
            assert qpl in (1, 2, 4, 6, 8) and 4 * 32 * qpl >= dv, where
            assert warps % rows == 0 and 1 <= split <= 8 and split & (split - 1) == 0, where
            assert -(-E // rows) * split >= sms, where
            wr = warps // rows
            tg = wr * _tile(qpl)
            assert wr & (wr - 1) == 0 and tg % 16 == 0, where
            assert _tile(qpl) == (32 if dv <= 128 else 8), where
            if dv <= 128 and E >= 4 * sms:
                assert (wr, rows) == (2, 4), where
            if dv > 128 and E >= sms:
                assert (wr, rows) == ((2, 2) if s2 <= 128 else (4, 1)), where
            assert stages == 2, where
            smem = rows * da._k1_group_bytes(qpl, dk, dv, 1, wr, stages, 2 if mixed else 1, 2)
            assert 2 * (smem + 1024) <= 233472, where


def test_k8_schedule_fits_a_block():
    """Every operand the wrapper takes (dk <= 256, dv % 16 == 0 up to 1024,
    int4 or split int8 keys, any S/2) gets a shape whose row groups fit a
    CTA's 227 KB of shared memory and whose key rows are whole 16-byte
    chunks; the partials fit the ring."""
    for dk in (1, 64, 256):
        for dv in (16, 48, 64, 128, 144, 768, 1024):
            for mixed in (False, True):
                for e, s2 in ((1, 1), (96, 1056), (1536, 128), (5000, 8192)):
                    qpl, warps, rows, split, stages = da._k8_schedule(e, dk, dv, s2, mixed, 132)
                    wr = warps // rows
                    tw = _tile(qpl)
                    where = (dk, dv, mixed, e, s2)
                    assert wr * tw % 16 == 0, where
                    kr = 2 if mixed else 1
                    group = da._k1_group_bytes(qpl, dk, dv, 1, wr, stages, kr, 2)
                    assert rows * group <= 232448, where
                    # the partials (m, l, pad, pad, acc[dv]) in one stage
                    stage = (group - da._round16(4 * dk) - wr * da._round16(8 * tw)) // stages
                    assert wr * (16 + da._round16(4 * dv)) <= stage, where
