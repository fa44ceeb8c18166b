"""Compare K9 (the block-sparse attention, forward and backward) and the
kernels whose bodies it shares, K3 and K5, between two checkouts of the
port on one GPU.

    python3 bench_blocksparse.py [--tree DIR] [--label NAME] [--rows 64,128]
                                 [--key-tiles 64,128] [--out FILE]

Runs the port found under ``--tree`` (the root of a checkout; default: the
one this script lies in) through ``chip_smoke.py``'s own cases and runners,
imported from beside this script, so that two commits compare in one call:
unpack the other one with ``git archive`` into a directory that
``.gitignore`` lists and run parent, change, change, parent.

1. K9 at chip_smoke's long-context cases (b 4, s 4096, h 12, d 64, bf16,
   the band mask of 256 x 256 blocks: the forward, ragged and with an
   empty query block, and the backward) and past the old 512-block cap
   (block 64: the forward at sq 128 over sk 33,280, the backward at sq
   33,280 over sk 128); a tree that refuses a shape records the error.
2. ``chip_smoke.phase_longctx``: K3, K3 + K5 and the block-sparse op
   forward + backward at s 2k/4k/8k, 16384 tokens, with the launches of
   one call.
3. K3's headline cases (the serve prefill, 128 x 12 x 32 over 512; the
   training forward, 32 x 12 x 512 with dropout 0.1; train-8k's 1 x 12 x
   8192 with dropout 0.1) and K5's (the training shape, 32 x 12 x 512,
   and 2 x 12 x 8192, dropout 0.1).

``--rows`` and ``--key-tiles`` (a tree whose wrapper has ``_k9_rows`` and
``_k9_key_tile``) repeat the K9 cases of 1, last, at each forced forward
row tile and backward key tile (where it divides the block).

Every case through ``chip_smoke.phase_kernels``: errors under the 2x rule,
CUDA-event ms, profiler device ms with the launches it recorded, host
microseconds a call, the bound and the library call's times, and the
launches the port counted in one call. One JSON line each (the card's name
and power limit first); ``--out`` writes them all as one JSON list. Exits
non-zero without a card.
"""

import argparse
import json
import sys
from pathlib import Path

import torch

import chip_smoke as cs


def _older_k9(fa, build):
    """Run a tree whose K9 has two backward kernels and takes the active
    tiles, not a blockmask and tables (the port before its backward became
    one C entry), through this script's cases: the causal pre-filter made
    once a mask, outside the timed calls, as that tree's op made it before
    its kernels; called with a blockmask, the forward returns it as the
    third result, standing for the tables (that tree's own op calls it
    with its active tiles and takes two); the backward its dq kernel, then
    its dk/dv kernel."""
    if hasattr(fa, "_bs_bwd_kernel"):
        return
    cs.K9 = tuple(n for n in build.KERNELS if n.startswith("blocksparse_"))
    fwd = fa._bs_fwd_kernel
    made = {}    # id(mask) -> (mask, its active tiles): once a mask

    def active(mask, kw):
        if mask.dtype == torch.bool:      # that tree's op: already filtered
            return mask
        if id(mask) not in made:
            made[id(mask)] = (mask, fa.blocksparse_active(mask, kw["causal"], kw["block_q"],
                                                          kw["block_k"]))
        return made[id(mask)][1]

    def fwd_kernel(q, k, v, mask, **kw):
        out = fwd(q, k, v, active(mask, kw), **kw)
        return out if mask.dtype == torch.bool else (*out, mask)

    fa._bs_fwd_kernel = fwd_kernel
    fa._bs_bwd_kernel = lambda *a, **kw: (
        fa._bs_bwd_dq_kernel(*a[:6], active(a[6], kw), **kw),
        *fa._bs_bwd_dkv_kernel(*a[:6], active(a[6], kw), **kw))


def k9_cases(gen, add):
    """chip_smoke's K9 cases: the long-context ones (K7's draws made and
    dropped, so that K9's inputs are chip_smoke's), then past the cap (a
    tree that refuses it fails while the backward case runs its forward,
    after every draw)."""
    cases = [c for c in cs.longctx_kernel_cases(gen) if c[0].startswith("blocksparse")]
    try:
        cases += cs.k9_past_cap_cases(gen)
    except (RuntimeError, ValueError) as exc:
        add({"kernel": "blocksparse", "case": "past-cap", "error": str(exc)[:300]})
    return cases


def k3_k5_cases(gen):
    """K3's prefill, training and 1 x 8192 cases and K5's two, from
    chip_smoke's own case functions."""
    keep = ("flash_attention", "flash_attention_bwd")
    cases = [c for c in cs.k3_cases(gen) if c[1].startswith("prefill")]
    cases += [c for c in cs.train_kernel_cases(gen) if c[0] in keep]
    return cases + cs.long_flash_cases(gen) + cs.long_flash_bwd_cases(gen)


def run_case(case, build, add):
    """One case through phase_kernels, with the launches the port counted
    in one call of it beside; a refused shape is recorded."""
    c = case[2]
    c["device_times"] = True
    c.pop("gate", None)
    try:
        build.reset_launches()
        c["kernel"]()
        torch.cuda.synchronize()
        counted = {k: n for k, n in build.launch_counts().items() if n}
        made = cs.phase_kernels([case], {})
    except (RuntimeError, ValueError) as exc:
        add({"kernel": case[0], "case": case[1], "error": str(exc)[:300]})
        return
    for row in made:
        add({"kernel": case[0], **row, "counted_launches": counted})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parent)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--rows", default="")
    ap.add_argument("--key-tiles", default="")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_blocksparse: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(args.tree.resolve()))
    from backpacks_flash_attn_tpu_torch.ops import _build
    from backpacks_flash_attn_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = [{"label": args.label, "tree": str(args.tree), "nvidia_smi": cs.nvidia_smi_line(),
             "device": torch.cuda.get_device_name(0), "package": _build.__file__}]
    cs.emit(rows[0])
    _build.build_all([n for n in _build.KERNELS
                      if n.startswith(("blocksparse_", "flash_attention"))])
    add = lambda row: (rows.append({"label": args.label, **row}), cs.emit(rows[-1]))
    _older_k9(fa, _build)

    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    with torch.no_grad():
        for case in k9_cases(gen, add):
            run_case(case, _build, add)
        torch.cuda.empty_cache()

    results = {}
    cs.phase_longctx(gen, results)
    for s, row in results["longctx"]["runs"].items():
        add({"case": f"longctx {s}", **row})
    torch.cuda.empty_cache()

    with torch.no_grad():
        for case in k3_k5_cases(gen):
            run_case(case, _build, add)
            torch.cuda.empty_cache()
        # last, so that the draws of the runs above stay those of a run
        # without the options
        forced = [("_k9_rows", int(r)) for r in filter(None, args.rows.split(","))]
        forced += [("_k9_key_tile", int(t)) for t in filter(None, args.key_tiles.split(","))]
        for attr, size in forced:
            default = getattr(fa, attr)
            # the block the tile must divide: _k9_rows(sq, block_q, d),
            # _k9_key_tile(sq, sk, block_k, d)
            block = 1 if attr == "_k9_rows" else 2
            setattr(fa, attr, lambda *a, size=size, default=default, block=block: (
                size if a[block] % size == 0 else default(*a)))
            try:
                for name, label, c in k9_cases(gen, add):
                    run_case((name, f"{label} {attr}={size}", c), _build, add)
            finally:
                setattr(fa, attr, default)
            torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
