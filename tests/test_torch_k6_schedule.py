"""K6's work split (``csrc/fused_contextualization_bwd.cu``), on the CPU: no
JAX and no card needed.

The loops of the three passes are written out here as the kernels run
them, on 64-row tiles (n = ceil(s / 64) of them):

- the delta pass: CTA y of a (batch, head) owns query tile t = n - 1 - y
  and streams the key tiles [0, t];
- the main pass: CTA y owns key tile j = y and streams the query tiles
  [j, n);
  in both, warpgroup w takes the streamed tiles ui = w, w + 2, ..., and
  the ring's stages go to the pairs (2 p, 2 p + 1) chunk by chunk in turn
  (``dp_stage``);
- the dcontent pass: CTA (x, y, z) owns key tiles hi = n - 1 - y and lo = y
  (one tile where they meet), columns [192 z, 192 z + 192) of d and the
  sense heads of group x (``_k6_heads`` of them). For each head it streams
  the query tiles [hi, n) with warpgroup 0 on tile hi and 1 on tile lo,
  then [lo, hi) (or [lo, n) for a lone tile) with both on tile lo,
  warpgroup w taking queries [32 w, 32 w + 32) of each stage.

The checks, at the training shape's s = 512 and at ragged ones: each pass
multiplies every causal (row, column) pair of a head exactly once; the
delta and main passes launch their heaviest tiles first, and their ring
stages are numbered once each, in the producer's order; every dcontent
CTA that owns two tiles does the same products (n + 1 tiles of 64 x 64 a
head) and reads each dO tile once a head, a lone tile does fewer; the
slabs cover d once; the head groups cover the heads once and, at the
forward's and training's shapes, fill about four waves of 132 SMs.
"""

from backpacks_flash_attn_tpu_torch.ops import backpack_kernels as bk

import numpy as np

SLAB = 192


def _dp_stage(ui, c, r, n_u):
    """The ring stage of chunk c of streamed tile ui (csrc ``dp_stage``)."""
    p = ui >> 1
    return 2 * p * r + (2 * c + (ui & 1) if 2 * p + 1 < n_u else c)


def _dp_pass(s, main):
    """Per CTA y: the (row tile, streamed tiles) of the delta or main pass."""
    n = -(-s // 64)
    for y in range(n):
        tile = y if main else n - 1 - y
        yield tile, (range(tile, n) if main else range(tile + 1))


def _dc_pass(s):
    """Per CTA y: its runs as (query tiles, [(key tile, query offset, queries)
    per warpgroup])."""
    n = -(-s // 64)
    for y in range((n + 1) // 2):
        hi, lo = n - 1 - y, y
        runs = []
        if hi != lo:
            runs.append((range(hi, n), [(hi, 0, 64), (lo, 0, 64)]))
        runs.append((range(lo, hi if hi != lo else n), [(lo, 32 * w, 32) for w in (0, 1)]))
        yield runs


def test_k6_passes_cover_causal_work_once():
    for s in (512, 1, 33, 64, 65, 130, 200, 300, 1000):
        n = -(-s // 64)
        row = np.arange(64 * n)[:, None]
        col = np.arange(64 * n)[None, :]
        for main in (False, True):
            # count[row, col]: rows are the CTA tile's (queries in the delta
            # pass, keys in the main pass), columns the streamed ones
            count = np.zeros((64 * n, 64 * n), dtype=np.int32)
            work = []
            for tile, streamed in _dp_pass(s, main):
                for u in streamed:
                    count[64 * tile:64 * tile + 64, 64 * u:64 * u + 64] += 1
                work.append(len(streamed))
            causal = (col >= row) if main else (col <= row)
            valid = causal & (row < s) & (col < s)
            assert (count[valid] == 1).all() and count.max() == 1, (s, main)
            assert work == sorted(work, reverse=True), (s, main, work)   # heaviest first
        for n_u in range(1, n + 1):
            for r in (1, 2, 10, 12, 16):
                produced = [_dp_stage(ui0 + w, c, r, n_u)
                            for ui0 in range(0, n_u, 2) for c in range(r)
                            for w in range(2 if ui0 + 1 < n_u else 1)]
                assert produced == list(range(n_u * r)), (n_u, r)
        # dcontent: count[key, query]
        count = np.zeros((64 * n, 64 * n), dtype=np.int32)
        pairs, lone = set(), []
        for y, runs in enumerate(_dc_pass(s)):
            reads, units = [], 0
            for tiles, wgs in runs:
                for u in tiles:
                    reads.append(u)
                    for kt, q0, kw in wgs:
                        count[64 * kt:64 * kt + 64, 64 * u + q0:64 * u + q0 + kw] += 1
                        units += kw
            assert len(reads) == len(set(reads)), (s, reads)    # each dO tile once
            if n - 1 - y == y:
                lone.append(units)
            else:
                pairs.add(units)
        valid = (col >= row) & (row < s) & (col < s)
        assert (count[valid] == 1).all() and count.max() == 1, s
        assert len(pairs) <= 1, (s, pairs)
        assert pairs <= {64 * (n + 1)}, (s, pairs)
        assert all(u <= 64 * (n + 1) for u in lone), (s, lone)
    for d in (768, 640, 384, 200, 64, 1152):
        cols = [c for z in range(-(-d // SLAB)) for c in range(z * SLAB, min(d, (z + 1) * SLAB))]
        assert cols == list(range(d)), d


def test_k6_head_groups():
    for b, s, nv, d in ((32, 512, 16, 768), (8, 512, 16, 640), (8, 512, 16, 768),
                        (2, 512, 16, 768), (1, 200, 4, 768), (2, 1, 3, 768),
                        (4, 1000, 16, 384), (1, 64, 5, 64)):
        hpc = bk._k6_heads(b, s, nv, d, 132)
        assert 1 <= hpc <= nv
        groups = [range(h0, min(nv, h0 + hpc)) for h0 in range(0, nv, hpc)]
        assert [h for grp in groups for h in grp] == list(range(nv))
        units = b * ((-(-s // 64) + 1) // 2) * -(-d // SLAB)    # CTAs of one head each
        if b * s >= 8 * 512:        # the forward's and training's shapes
            assert 3 * 132 <= units * len(groups) <= 6 * 132, (b, s, nv, d, hpc)
        if hpc > 1:                 # one head fewer a CTA would pass four waves
            assert units * nv / (hpc - 1) > 4 * 132, (b, s, nv, d, hpc)
