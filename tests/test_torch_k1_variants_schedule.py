"""The launch schedules of K1's redesigns on the CPU (K1-selector's with its
value-transposed ring, K1-gathered's length-balanced split): no JAX and no
card needed.

The selector runs K1's kernel body (``csrc/decode_attention.cuh``) over the
format FMT_VT: values (E, dv, S), so a group tile's values arrive as
round4(dv) channel rows of vcs = round16(Tg x elt) bytes, channel c in row
r = (c % 4) Qd + c / 4 (Qd = ceil(dv / 4)), the row's 16-byte chunk t at
t ^ ((r >> vsh) & vm). The wrapper sizes the launch with
``ops/decode_attention.py`` ``_k1_schedule(..., vt=True)``, whose ring bytes
(``_k1_group_bytes(..., vt=True)``) must be the kernel's ``Layout``:
``_layout`` below transcribes it line for line. The check, over the decode
shapes, dk 64-256, dv 1-1024, S up to 65,536 and the three element sizes:
the bytes agree and fit a block, the partials fit the ring, a tile's channel
runs are at least 64 bytes, the copies fill the value slab one to one,
every (channel, position) of a warp's slice is read once by one lane, at
the address its copy wrote, and the lanes of one load spread over the
banks.
"""

import numpy as np

from backpacks_flash_attn_tpu_torch.ops import decode_attention as da

BLOCK_SMEM, SM_SMEM, SMEM_RESERVED = 232448, 233472, 1024
# (E, dk, dv, S): the decode-kernels phase's GPT rows and Backpack combine at
# S 128-512, gpt-generate's rows at 2112, the S 65,536 cases (card test, chip
# smoke), then a grid of widths
DECODE_SHAPES = ([(e, 64, dv, s) for e, dv in ((1536, 64), (2048, 768))
                  for s in (128, 256, 512)]
                 + [(96, 64, 64, 2112), (4, 64, 64, 65536), (96, 64, 64, 65536)])
GRID = [(e, dk, dv, s) for e in (1, 96, 2048) for dk in (64, 128, 256)
        for dv in (1, 3, 4, 60, 64, 100, 128, 129, 768, 1000, 1024)
        for s in (1, 300, 65536)]


def _r16(x):
    return (x + 15) & ~15


def _layout(elt, qpl, dk, dv, wr, stages):
    """csrc/decode_attention.cuh ``Layout(elt, qpl, dk, dv, wr, stages, 1, 1,
    true)``."""
    tw = max(4, (32 if qpl == 1 else 8) // elt)
    tg = wr * tw
    vcs = _r16(tg * elt)
    v_off = _r16(dk * tg * elt)
    ks_off = v_off + ((dv + 3) & ~3) * vcs
    vs_off = ks_off + 4 * tg
    stage = _r16(vs_off + 4 * tg)
    q_off = stages * stage
    p_off = q_off + _r16(4 * dk)
    return dict(tw=tw, tg=tg, vcs=vcs, v_off=v_off, ks_off=ks_off, stage=stage,
                q_off=q_off, part=16 + _r16(4 * dv), group=p_off + wr * _r16(4 * tw))


def _slab(elt, qpl, dv, wr):
    """The kernel's value slab for one warp shape: (copy address of each
    (channel, chunk), read addresses of each load as {lane: address} for
    every warp wi, unit u, quad j and channel k, the (channel, position)
    each lane reads, the unit's bytes)."""
    tw = max(4, (32 if qpl == 1 else 8) // elt)
    vcs = _r16(wr * tw * elt)
    kcv = vcs >> 4
    assert kcv & (kcv - 1) == 0
    kcs = kcv.bit_length() - 1
    vm, vsh = min(kcv, 8) - 1, 0 if kcv >= 8 else 3 - kcs
    qd_n = (dv + 3) // 4
    row = lambda c: (c & 3) * qd_n + (c >> 2)
    addr = lambda r, t: r * vcs + ((t ^ ((r >> vsh) & vm)) << 4)
    copies = {(c, t): addr(row(c), t) for c in range(dv) for t in range(kcv)}
    lp = 1
    while lp < qd_n and lp < 32:
        lp <<= 1
    ps = 32 // lp
    unit = min(16, tw * elt)
    loads, reads = {}, {}
    for wi in range(wr):
        for lane in range(32):
            lq, ps0 = lane % lp, lane // lp
            for u in range(ps0, tw * elt // unit, ps):
                b = wi * tw * elt + u * unit
                for j in range(qpl):
                    qd = lq + lp * j
                    for k in range(4):
                        if qd >= qd_n or 4 * qd + k >= dv:
                            continue
                        r = k * qd_n + qd
                        a = addr(r, b >> 4) + (b & 15)
                        loads.setdefault((wi, u, j, k), {})[lane] = a
                        c = 4 * qd + k
                        for i in range(unit // elt):
                            pos = wi * tw + (b - wi * tw * elt) // elt + i
                            reads.setdefault((c, pos), []).append(a + i * elt)
    return copies, loads, reads, vcs, unit


def _max_per_bank(lanes, unit):
    """The most lanes of one load that share a bank slot: quarter-warps of
    16-byte loads, half-warps of 8-byte loads, distinct addresses only."""
    group = 128 // unit
    worst = 0
    for g in range(0, 32, group):
        slots = {}
        for lane in range(g, g + group):
            if lane in lanes:
                slots.setdefault((lanes[lane] % 128) // unit, set()).add(lanes[lane])
        worst = max([worst] + [len(a) for a in slots.values()])
    return worst


def test_vt_ring_matches_kernel_layout():
    slabs = {}
    for elt in (1, 2, 4):
        for e, dk, dv, s in DECODE_SHAPES + GRID:
            where = (elt, e, dk, dv, s)
            qpl, warps, rows, split, stages = da._k1_schedule(e, dk, dv, s, elt, 132, True)
            wr = warps // rows
            lay = _layout(elt, qpl, dk, dv, wr, stages)
            assert lay["group"] == da._k1_group_bytes(qpl, dk, dv, elt, wr, stages, vt=True), where
            assert rows * lay["group"] <= BLOCK_SMEM, where
            assert lay["tg"] * elt % 16 == 0 and 4 * 32 * qpl >= dv, where
            assert lay["tg"] * elt >= (128 if qpl == 1 else 64), where   # the channel runs
            assert wr * lay["part"] <= lay["q_off"], where  # the partials reuse the ring
            if qpl == 1 and dv * elt % 16 == 0:     # K1's ring bytes, so K1's launch shape
                assert (qpl, warps, rows, split, stages) == da._k1_schedule(e, dk, dv, s, elt, 132)
            if (elt, qpl, dv, wr) not in slabs:
                slabs[elt, qpl, dv, wr] = _slab(elt, qpl, dv, wr)
            copies, loads, reads, vcs, unit = slabs[elt, qpl, dv, wr]
            assert vcs == lay["vcs"], where
            # the copies fill the slab one to one
            starts = sorted(copies.values())
            assert len(set(starts)) == len(starts), where
            assert all(a % 16 == 0 and a + 16 <= lay["ks_off"] - lay["v_off"] for a in starts)
            # each (channel, position) of every warp's slice read once, where
            # its chunk was copied
            assert len(reads) == dv * lay["tg"], where
            for (c, pos), got in reads.items():
                assert got == [copies[c, pos * elt // 16] + pos * elt % 16], (where, c, pos)
            # a quarter-warp's 16-byte loads on distinct banks, a half-warp's
            # 8-byte loads two to a bank, where the quads fill the lanes
            worst = max(_max_per_bank(lanes, unit) for lanes in loads.values())
            assert worst <= (4 if dv % 32 else 1 if unit == 16 else 2), (where, worst)


def _k1_layout(elt, qpl, dk, dv, wr, stages):
    """csrc/decode_attention.cuh ``Layout(elt, qpl, dk, dv, wr, stages)``
    (FMT_K1: one key run, one position a column, values (E, S, dv))."""
    tw = max(4, (32 if qpl == 1 else 8) // elt)
    tg = wr * tw
    p = 16 // elt
    dvp = -(-dv // p) * p
    v_off = _r16(dk * tg * elt)
    ks_off = v_off + _r16(tg * dvp * elt)
    stage = _r16(ks_off + 8 * tg)
    q_off = stages * stage
    p_off = q_off + _r16(4 * dk)
    return dict(tg=tg, stage=stage, q_off=q_off, part=16 + _r16(4 * dv),
                group=p_off + wr * _r16(4 * tw))


def _balanced_segments(lens, s, tg, grid):
    """csrc/decode_attention_gathered.cu's partition, stated in Python: the
    rows' valid group tiles laid end to end, CTA c < G' = min(grid, T) taking
    [c T / G', (c + 1) T / G'); -> (row tiles, [(cta, row, first tile,
    count)], the segments a row's merge counts (cta_of over its first and
    last tile) or None for a row one segment covers)."""
    tiles = [0 if n <= 0 else -(-min(n, s) // tg) for n in lens]
    total = sum(tiles)
    ga = min(grid, total)
    starts = np.concatenate([[0], np.cumsum(tiles)]).tolist()
    cta_of = lambda t: ((t + 1) * ga - 1) // total
    segs, merged = [], {}
    for c in range(ga):
        t0, t1 = c * total // ga, (c + 1) * total // ga
        # the kernel's scan: the row that holds t0
        r = next(r for r in range(len(lens)) if tiles[r] and starts[r] <= t0 < starts[r + 1])
        rs = starts[r]
        while rs < t1:
            nt = tiles[r]
            if nt:
                first = max(t0, rs) - rs
                count = min(t1, rs + nt) - rs - first
                segs.append((c, r, first, count))
                if count != nt:
                    merged[r] = cta_of(rs + nt - 1) - cta_of(rs) + 1
            rs += nt
            r += 1
    return tiles, segs, merged


def test_gathered_schedule_balances_the_card():
    """K1-gathered's launch (``_gathered_schedule``) over E 1-4096, dk
    64-256, dv 4-1024, S up to 65,536 and the three element sizes: K1's own
    launch exactly where K1's schedule needs no split; otherwise CTAs of
    K1's row group on a ring of 2 stages, as many an SM as K1's register
    bound and the shared memory allow (the ring's bytes the kernel's
    Layout), the scan's words and the ticket word inside
    the ring and q; and, for lengths drawn with zeros (a row past S, every
    row empty, a scalar length), the kernel's partition covers each valid
    tile exactly once, gives no CTA more than one tile over another, puts
    every partial in its own slot of the workspace, and counts each merged
    row's segments right."""
    rng = np.random.default_rng(18)
    shapes = [(96, 64, 64, 2112, 2), (96, 64, 64, 16384, 2), (96, 64, 64, 65536, 2),
              (12, 64, 64, 16384, 2), (4, 64, 64, 65536, 2), (13, 64, 128, 2112, 1)]
    for _ in range(400):
        shapes.append((int(rng.choice([1, 2, 7, 40, 96, 131, 132, 600, 4096])),
                       int(rng.choice([64, 128, 256])),
                       int(rng.choice([4, 60, 64, 128, 132, 768, 1000, 1024])),
                       int(rng.integers(1, 65537)), int(rng.choice([1, 2, 4]))))
    balanced = 0
    for e, dk, dv, s, elt in shapes:
        where = (e, dk, dv, s, elt)
        sched = da._gathered_schedule(e, dk, dv, s, elt, 132)
        k1 = da._k1_schedule(e, dk, dv, s, elt, 132)
        assert (sched is None) == (k1[3] == 1), where
        if sched is None:
            continue
        balanced += 1
        qpl, warps, stages, grid, ws_floats = sched
        assert (qpl, warps) == k1[:2] and k1[2] == 1, where    # K1's row group
        lay = _k1_layout(elt, qpl, dk, dv, warps, stages)
        assert lay["group"] == da._k1_group_bytes(qpl, dk, dv, elt, warps, stages), where
        per_sm = grid // 132
        assert grid == 132 * per_sm and 1 <= per_sm <= 16 // warps, where
        assert lay["group"] <= BLOCK_SMEM and per_sm * (lay["group"] + SMEM_RESERVED) <= SM_SMEM
        assert stages == 2 and lay["tg"] * elt % 16 == 0, where
        if per_sm < 16 // warps:     # as many an SM as K1's register bound and the rings allow
            assert (per_sm + 1) * (lay["group"] + SMEM_RESERVED) > SM_SMEM, where
        assert warps * lay["part"] <= lay["q_off"], where   # the partials reuse the ring
        assert lay["stage"] >= 80 and lay["q_off"] + 4 <= lay["group"], where
        slot_floats = lay["part"] // 4
        assert ws_floats == (grid + e - 1) * slot_floats, where
        draws = [rng.integers(-3, s + 4, e), np.zeros(e, np.int64), np.full(e, s + 9),
                 np.full(e, int(rng.integers(1, s + 1)))]
        draws[0][rng.random(e) < 0.2] = 0
        for lens in draws:
            tiles, segs, merged = _balanced_segments(lens.tolist(), s, lay["tg"], grid)
            pieces = {}
            for c, r, first, count in segs:
                pieces.setdefault(r, []).append((first, count))
            for r, nt in enumerate(tiles):     # each row's tiles once, in order
                pos = 0
                for first, count in sorted(pieces.get(r, [])):
                    assert first == pos and count >= 1, where
                    pos += count
                assert pos == nt, where
            work = {}
            for c, _, _, count in segs:
                work[c] = work.get(c, 0) + count
            if work:
                assert max(work.values()) - min(work.values()) <= 1, where
                assert len(work) == min(grid, sum(tiles)), where
            slots = [c + r for c, r, first, count in segs if count != tiles[r]]
            assert len(set(slots)) == len(slots) and all(x < grid + e - 1 for x in slots)
            for r, n in merged.items():
                assert n == sum(1 for _, rr, _, _ in segs if rr == r) >= 2, where
    assert balanced >= 50
