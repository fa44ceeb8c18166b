"""K4's row tiling (``ops/backpack_kernels.py`` ``_k4_rows``) and the causal
work of its blocks, on the CPU: no JAX and no card needed.

The C entry takes the tiling as the wrapper gives it. The block loops of
``ctx_wgmma_kernel`` (``csrc/fused_contextualization.cu``) are written out
in ``_runs``: block (x, y, batch) owns the query-row tiles hi = n - 1 - x
and lo = x (one tile where they meet) and columns [192 y, 192 y + 192) of
d, and walks runs of stages, each run a range of 64-key tiles for every
head. At 128 rows: tile hi's key tiles, then tile lo's, warpgroup w on rows
[64 w, 64 w + 64) of the tile and all 64 keys of a stage. At 64 rows: the
key tiles [0, lo] with warpgroup 0 on tile hi and 1 on tile lo, then (lo,
hi] with both on tile hi, warpgroup w taking keys [32 w, 32 w + 32). The
checks: every causal (row, key) pair of a head is multiplied exactly once
in each slab, the slabs cover d exactly once, a block reads each content
tile at most once at 64 rows, and blocks that own two tiles do the same
products (a lone middle tile does fewer).
"""

import numpy as np

from backpacks_flash_attn_tpu_torch.ops import backpack_kernels as bk

SMS = 132
SLAB = 192


def _runs(s, rows):
    """Per block: its runs (kt0, kt1, [(row slice, key offset, keys) per
    warpgroup]), rows and keys absolute, keys relative to each key tile."""
    n_rows, n_keys = -(-s // rows), -(-s // 64)
    for x in range((n_rows + 1) // 2):
        hi, lo = n_rows - 1 - x, x
        if rows == 128:
            yield [(0, min(n_keys, 2 * t + 2),
                    [(slice(128 * t + 64 * w, 128 * t + 64 * w + 64), 0, 64) for w in (0, 1)])
                   for t in ([hi, lo] if hi != lo else [hi])]
        else:
            runs = []
            if hi != lo:
                runs.append((0, lo + 1, [(slice(64 * hi, 64 * hi + 64), 0, 64),
                                         (slice(64 * lo, 64 * lo + 64), 0, 64)]))
            runs.append((lo + 1 if hi != lo else 0, hi + 1,
                         [(slice(64 * hi, 64 * hi + 64), 32 * w, 32) for w in (0, 1)]))
            yield runs


def test_k4_rows_fill_the_card():
    for b, s, d in ((8, 512, 768), (32, 512, 768), (8, 512, 640), (32, 512, 640),
                    (1, 70, 768), (2, 130, 384)):
        rows = bk._k4_rows(b, s, d, SMS)
        assert rows in (64, 128)
        blocks = (-(-s // rows) + 1) // 2 * -(-d // SLAB) * b
        if b * s >= 8 * 512:    # the forward's and training's shapes: a wave or more
            assert blocks >= 0.95 * SMS, (b, s, d, rows, blocks)
    assert -(-768 // SLAB) == 4   # scores recomputed 4 times at d 768


def test_k4_blocks_cover_causal_work_once():
    for s in (512, 70, 200, 300, 129, 33, 64, 1000):
        for d in (768, 640, 384, 800, 64):
            cols = [c for y in range(-(-d // SLAB))
                    for c in range(y * SLAB, min(d, (y + 1) * SLAB))]
            assert cols == list(range(d)), (s, d)
        for rows in (64, 128):
            n_keys = -(-s // 64)
            count = np.zeros((-(-s // rows) * rows, n_keys * 64), dtype=np.int32)
            n_rows = -(-s // rows)
            pairs, lone = set(), []
            for x, runs in enumerate(_runs(s, rows)):
                reads, units = [], 0
                for kt0, kt1, wgs in runs:
                    for kt in range(kt0, kt1):
                        reads.append(kt)
                        for r, k0, kw in wgs:
                            count[r, 64 * kt + k0:64 * kt + k0 + kw] += 1
                            units += kw
                if rows == 64:
                    assert len(reads) == len(set(reads)), (s, reads)
                if n_rows - 1 - x == x:
                    lone.append(units)
                else:
                    pairs.add(units)
            row = np.arange(count.shape[0])[:, None]
            key = np.arange(count.shape[1])[None, :]
            causal = (key <= row) & (row < s) & (key < s)
            assert (count[causal] == 1).all(), (s, rows)
            assert count.max() == 1, (s, rows)
            assert len(pairs) <= 1, (s, rows, pairs)
            assert len(lone) <= 1 and all(u <= min(pairs, default=u) for u in lone)
