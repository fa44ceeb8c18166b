"""K9's tile tables (``ops/flash_attention.py`` ``_bs_tables``) and the tile
walks its kernels take over them, on the CPU: no JAX and no card needed.

The walks are written out below as the kernels run them:
``csrc/blocksparse_attention.cu`` ``SparseKeys`` (the forward: a CTA of
``rows`` query rows walks its query block's active key blocks in 64-key
tiles up to its last visible key, and each warp of 16 * MT rows skips the
tiles past its own) over K3's body (``csrc/flash_attention.cuh``), and
``csrc/blocksparse_attention_bwd.cu`` ``SparseQueries`` (the backward: a
CTA of ``key_tile`` keys walks its key block's active query blocks in
64-query tiles from its first key on when causal, each warp of 16 keys
skipping the tiles wholly below it) over K5's
(``csrc/flash_attention_bwd.cuh``). Each test loops over one grid: causal
or not, sq == sk and not, blocks 64 / 128 / 256, band, random and
empty-row masks, and more than 512 blocks a row or a column (the old
kernels' cap). The checks: the tables list each block's active tiles in
order; both walks visit every valid (query, key) pair of the plain
version's mask (``_bs_mask``) exactly once and no warp tile that lies
wholly above the diagonal or past sk; each launch's CTAs come in
descending order of the tiles they visit.
"""

import re
from pathlib import Path

import numpy as np
import torch

from backpacks_flash_attn_tpu_torch.ops import flash_attention as fa

T = 64  # the kernels' tile: blocks split into 64 rows or keys


def _mask(kind, n_qb, n_kb, seed):
    rng = np.random.default_rng(seed)
    qi, kj = np.arange(n_qb)[:, None], np.arange(n_kb)[None, :]
    if kind == "band":
        m = ((kj <= qi) & ((qi - kj) < 3)) | (kj == 0)
    else:
        m = rng.random((n_qb, n_kb)) < 0.5
    if kind == "empty-row":
        m[n_qb // 2] = False
    return torch.as_tensor(m.astype(np.int32))


# (causal, sq, sk, block_q, block_k, mask): the card tests' and
# chip_smoke's shapes cut down, and past the old cap (520 blocks)
GRID = [
    (causal, sq, sk, bq, bk, kind)
    for causal in (True, False)
    for sq, sk in ((384, 384), (200, 330), (330, 200), (1300, 1300))
    for bq, bk in ((64, 64), (128, 128), (256, 256), (128, 64), (64, 256))
    for kind in ("band", "random", "empty-row")
] + [(False, 128, 33280, 64, 64, "random"), (False, 33280, 128, 64, 64, "random"),
     (True, 33280, 512, 64, 64, "random")]


def _cases():
    for i, (causal, sq, sk, bq, bk, kind) in enumerate(GRID):
        n_qb, n_kb = -(-sq // bq), -(-sk // bk)
        active = fa.blocksparse_active(_mask(kind, n_qb, n_kb, i), causal, bq, bk)
        tables = fa._bs_tables(active, sq, sk, causal=causal, block_q=bq, block_k=bk)
        yield (causal, sq, sk, bq, bk, kind), active, tables


def _fwd_walk(t, rank, sq, sk, causal, bq, bk):
    """SparseKeys over flash_fwd_mma_kernel for CTA ``rank``: its first
    query row, and the (first row, rows, first key) of each warp product."""
    rows = t.rows
    mt = 2 if rows == 128 else 1
    rw = 16 * mt
    q0 = int(t.fwd_order[rank]) * rows
    qb = q0 // bq
    lst = t.row_idx[qb, :int(t.row_cnt[qb])].tolist()
    kv_len = sk
    kv_end = min(kv_len, min(q0 + rows, sq)) if causal else kv_len
    lo, hi = 0, len(lst)                       # SparseKeys.tiles
    while lo < hi:
        mid = (lo + hi) >> 1
        if lst[mid] * bk < kv_end:
            lo = mid + 1
        else:
            hi = mid
    tpb = bk // T
    n = 0 if lo == 0 else (lo - 1) * tpb + min(tpb, (kv_end - lst[lo - 1] * bk + T - 1) // T)
    products = []
    for tile in range(n):
        j0 = lst[tile // tpb] * bk + (tile % tpb) * T  # SparseKeys.key0
        for w in range(rows // rw):
            qw = q0 + rw * w
            warp_end = (0 if qw >= sq else min(kv_len, min(qw + rw, sq)) if causal
                        else kv_len)
            if j0 < warp_end:
                products.append((qw, rw, j0))
    return q0, n, products


def _bwd_walk(t, rank, sq, sk, causal, bq, bk):
    """SparseQueries over bwd_mma_kernel for CTA ``rank``: its first key,
    and the (first query, first key) of each warp product (64 queries x 16
    keys)."""
    bkt = t.key_tile
    k0 = int(t.bwd_order[rank]) * bkt
    kb = k0 // bk
    lst = t.col_idx[kb, :int(t.col_cnt[kb])].tolist()
    tpq = bq // T
    first = k0 if causal else 0
    lo, hi = 0, len(lst)
    while lo < hi:
        mid = (lo + hi) >> 1
        if (lst[mid] + 1) * bq <= first:
            lo = mid + 1
        else:
            hi = mid
    n = e0 = sub0 = 0
    if lo < len(lst):
        e0 = lo
        sub0 = max(0, first - lst[e0] * bq) // T
        last = min(tpq, (sq - lst[-1] * bq + T - 1) // T)
        n = max(0, (len(lst) - e0) * tpq - sub0 - (tpq - last))
    products = []
    for tile in range(n):
        u = sub0 + tile
        q0 = lst[e0 + u // tpq] * bq + (u % tpq) * T    # SparseQueries.q0
        for w in range(bkt // 16):
            kw = k0 + 16 * w
            if kw < sk and (not causal or q0 + T - 1 >= kw):
                products.append((q0, kw))
    return k0, n, products


def test_k9_tables_list_each_blocks_active_tiles_in_order():
    for key, active, t in _cases():
        a = active.numpy()
        for lists, cnt, m in ((t.row_idx, t.row_cnt, a), (t.col_idx, t.col_cnt, a.T)):
            assert lists.dtype == cnt.dtype == torch.int32, key
            assert lists.shape == m.shape, key
            for i in range(m.shape[0]):
                want = np.flatnonzero(m[i])
                assert int(cnt[i]) == len(want), key
                assert np.array_equal(lists[i, :len(want)].numpy(), want), key
        assert t.fwd_order.dtype == t.bwd_order.dtype == torch.int32, key


def test_k9_forward_walk_visits_each_valid_pair_once():
    for (causal, sq, sk, bq, bk, kind), active, t in _cases():
        key = (causal, sq, sk, bq, bk, kind)
        assert bq % t.rows == 0, key
        want = fa._bs_mask(active, 1, sq, sk, bq, bk, causal, None)[0, 0].numpy()
        seen = np.zeros((sq, sk), np.int8)
        starts = []
        for rank in range(len(t.fwd_order)):
            q0, _, products = _fwd_walk(t, rank, sq, sk, causal, bq, bk)
            starts.append(q0)
            for qw, rw, j0 in products:
                last = min(qw + rw, sq) - 1
                assert j0 < sk and (not causal or j0 <= last), (key, qw, j0)
                seen[qw:qw + rw, j0:j0 + T] += 1
        assert sorted(starts) == list(range(0, sq, t.rows)), key
        assert (seen[want] == 1).all(), key          # every valid pair once
        assert seen.max() <= 1, key                  # and no tile twice


def test_k9_backward_walk_visits_each_valid_pair_once():
    for (causal, sq, sk, bq, bk, kind), active, t in _cases():
        key = (causal, sq, sk, bq, bk, kind)
        assert bk % t.key_tile == 0, key
        want = fa._bs_mask(active, 1, sq, sk, bq, bk, causal, None)[0, 0].numpy()
        seen = np.zeros((sq, sk), np.int8)
        starts = []
        for rank in range(len(t.bwd_order)):
            k0, _, products = _bwd_walk(t, rank, sq, sk, causal, bq, bk)
            starts.append(k0)
            for q0, kw in products:
                assert q0 < sq and kw < sk, (key, q0, kw)
                assert not causal or q0 + T - 1 >= kw, (key, q0, kw)   # not wholly below
                seen[q0:q0 + T, kw:kw + 16] += 1
        assert sorted(starts) == list(range(0, sk, t.key_tile)), key
        assert (seen[want] == 1).all(), key
        assert seen.max() <= 1, key


def test_k9_launch_orders_put_most_work_first():
    for (causal, sq, sk, bq, bk, kind), active, t in _cases():
        key = (causal, sq, sk, bq, bk, kind)
        fwd = [_fwd_walk(t, r, sq, sk, causal, bq, bk)[1] for r in range(len(t.fwd_order))]
        bwd = [_bwd_walk(t, r, sq, sk, causal, bq, bk)[1] for r in range(len(t.bwd_order))]
        assert fwd == sorted(fwd, reverse=True), key
        assert bwd == sorted(bwd, reverse=True), key


def _c_ternary(expr: str, sq: int) -> int:
    """A C expression ``a ? x : b ? y : z`` of ``sq`` with integer arms."""
    while "?" in expr:
        cond, rest = expr.split("?", 1)
        arm, expr = rest.split(":", 1)
        if eval(cond, {}, {"sq": sq}):
            return int(arm)
    return int(expr)


def test_k9_tiles_follow_k3_and_k5_and_divide_the_blocks():
    """The forward's rows are K3's (32 / 64 / 128 by sq), the backward's
    key tile K5's (128 up to 1024, then 64), each cut to 64 where it does
    not divide the block. ``_k9_rows`` repeats the rule of ``k3_rows`` in
    ``csrc/flash_attention.cuh`` (the tables are sized in Python): read
    from the source, the C rule gives the same rows at every sq, so a
    change to it that leaves K9 behind fails here."""
    for sq, bq, rows in ((32, 64, 32), (200, 128, 64), (1024, 256, 64), (1025, 256, 128),
                         (8192, 256, 128), (8192, 64, 64), (8192, 192, 64)):
        assert fa._k9_rows(sq, bq) == rows, (sq, bq)
    for sq, sk, bk, tile in ((512, 512, 256, 128), (200, 330, 128, 128), (512, 512, 64, 64),
                             (4096, 4096, 256, 64), (128, 33280, 64, 64), (960, 192, 192, 64)):
        assert fa._k9_key_tile(sq, sk, bk) == tile, (sq, sk, bk)
    src = (Path(fa.__file__).resolve().parents[1] / "csrc" / "flash_attention.cuh").read_text()
    rule = re.search(r"inline int k3_rows\(long long sq\) \{ return ([^;]+); \}", src)
    assert rule is not None, "k3_rows not found in flash_attention.cuh"
    for sq in list(range(1, 2100)) + [4096, 8192, 16384, 33280]:
        assert fa._k9_rows(sq, 256) == _c_ternary(rule.group(1), sq), sq
