"""Compare K5 (the flash backward) and the runs it carries between two
checkouts of the port on one GPU.

    python3 bench_flash_bwd.py [--tree DIR] [--label NAME] [--key-tiles 64,128] [--out FILE]

Runs the port found under ``--tree`` (the root of a checkout; default: the
one this script lies in) through ``chip_smoke.py``'s own cases, yardsticks
and runners, imported from beside this script, so that two commits compare
in one call: unpack the other one with ``git archive`` into a directory
that ``.gitignore`` lists and run parent, change, change, parent.

1. K5 at the training shape (32 x 12 x 512, q/k/v strided views of one
   packed tensor) and at train-8k's (2 x 12 x 8192), causal, dropout 0.1,
   bf16, through ``chip_smoke.k5_case`` and ``phase_kernels``: errors under
   the 2x rule, one launch a call, CUDA-event ms, profiler device ms and
   host microseconds a call, each beside SDPA's backward, and the bound.
   ``--key-tiles`` (a tree whose wrapper has ``_k5_key_tile``) repeats both
   cases at each forced key-tile width.
2. Host microseconds of a K2 call (M 128, 768 -> 2304 INT8, the decode
   step's Wqkv) beside K5's: the launch path every kernel shares.
3. longctx: ``chip_smoke.phase_longctx`` (K3 and K3 + K5 at s 2k/4k/8k,
   16384 tokens, and the block-sparse pair).
4. Step ms of backpack-small train-einsum (32 x 512) and of train-8k
   (rotary gpt3-small, 2 x 8192, the fused MLP on), 12 steps each through
   ``chip_smoke.train_run`` (median of the 10 after 2 warm-up), with K5's
   device ms in the profiled step.

One JSON line each (the card's name and power limit first); ``--out``
writes them all as one JSON list. Exits non-zero without a card.
"""

import argparse
import json
import sys
from pathlib import Path

import torch

import chip_smoke as cs

# K5's kernels, by name, in the parent's form (three kernels) and this one's
K5_KERNELS = ("delta_kernel", "dkdv_kernel", "dq_kernel",
              "bwd_prep_kernel", "bwd_mma_kernel", "dq_convert_kernel")


def k5_device_ms(profile):
    """K5's device ms in one profiled step: the port's kernels of K5."""
    names = {}
    for row in profile["port"]:
        name = row["name"].removeprefix("void ").split("::", 1)[1].split("(")[0]
        base = name.split("<")[0]
        if base in K5_KERNELS:
            names[name] = names.get(name, 0.0) + row["ms"]
    return sum(names.values()), names


def k5_cases(gen, key_tile=None):
    randn = lambda *s: torch.randn(*s, generator=gen, device=cs.DEV)
    bf = torch.bfloat16
    tag = "" if key_tile is None else f" key_tile={key_tile}"
    b, s, h, d, p = cs.TRAIN_BATCH, cs.TRAIN_LEN, 12, 64, 0.1
    qkv = randn(b, s, 3, h, d).to(bf)
    dout = randn(b, s, h, d).to(bf)
    cases = [cs.k5_case(f"train b={b} h={h} s={s} p={p}{tag}", qkv[:, :, 0], qkv[:, :, 1],
                        qkv[:, :, 2], dout, (0x1234567, 0x89ABCDEF), p, 0.125)]
    b, s = cs.LONG_BATCH, cs.LONG_LEN
    q, k, v, dout = (randn(b, s, h, d).to(bf) for _ in range(4))
    cases.append(cs.k5_case(f"train8k b={b} h={h} s={s} p={p}{tag}", q, k, v, dout,
                            (0x2468ACE, 0x13579BDF), p, d ** -0.5, heads=4))
    return cases


def train_einsum(gen):
    """backpack-small, the einsum combine, 32 x 512 on the bigram corpus."""
    from backpacks_flash_attn_tpu_torch.config import backpack_small
    from backpacks_flash_attn_tpu_torch.data import lm_dataset as lmd
    from backpacks_flash_attn_tpu_torch.data.synthetic import bigram_corpus
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    from backpacks_flash_attn_tpu_torch.training import train as tl

    cfg = backpack_small(vocab_size=50257)
    n = cs.TRAIN_WARMUP + cs.TRAIN_TIMED
    toks, _ = bigram_corpus((n + 2) * cs.TRAIN_BATCH * (cs.TRAIN_LEN + 1) * 2,
                            vocab_size=cs.BIGRAM_VOCAB, n_successors=4, seed=0)
    ds = lmd.LMDataset(toks, cs.TRAIN_LEN)
    params = bp.init_backpack(cfg, gen, dtype=torch.bfloat16)
    stream = lmd.batches(ds, cs.TRAIN_BATCH, lmd.SamplerState(seed=0))
    batches = cs._lm_batches(next(stream)[0] for _ in range(n + 1))
    check = lambda c: (None if c["flash_attention_bwd"] == cfg.n_layer
                       else f"K5 launches {c['flash_attention_bwd']}")
    run, _ = cs.train_run("train_einsum", cfg, params, batches,
                          tl.make_train_step(cfg, fused_ctx=False), check)
    return run


def train_8k(gen):
    """rotary gpt3-small, 2 x 8192, the fused MLP on (chip_smoke's train-8k)."""
    from backpacks_flash_attn_tpu_torch.config import gpt3_small
    from backpacks_flash_attn_tpu_torch.models import gpt
    from backpacks_flash_attn_tpu_torch.ops import dense
    from backpacks_flash_attn_tpu_torch.training import train as tl

    cfg = gpt3_small(rotary=True, vocab_size=50257)
    params = gpt.init_gpt(cfg, gen, dtype=torch.bfloat16, device=cs.DEV)
    batches = [{"input_ids": torch.randint(0, cfg.vocab_size, (cs.LONG_BATCH, cs.LONG_LEN + 1),
                                           generator=gen, device=cs.DEV)}
               for _ in range(cs.TRAIN_WARMUP + cs.TRAIN_TIMED + 1)]
    check = lambda c: (None if c["flash_attention_bwd"] == cfg.n_layer
                       else f"K5 launches {c['flash_attention_bwd']}")
    switch = dense._FUSED_MLP
    dense._FUSED_MLP = True
    try:
        run, _ = cs.train_run("train_8k", cfg, params, batches,
                              tl.make_train_step(cfg, model="gpt"), check)
    finally:
        dense._FUSED_MLP = switch
    return run


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parent)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--key-tiles", default="")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_flash_bwd: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(args.tree.resolve()))
    from backpacks_flash_attn_tpu_torch.ops import _build
    from backpacks_flash_attn_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = [{"label": args.label, "tree": str(args.tree), "nvidia_smi": cs.nvidia_smi_line(),
             "device": torch.cuda.get_device_name(0), "package": _build.__file__}]
    cs.emit(rows[0])
    _build.build_all()
    add = lambda row: (rows.append({"label": args.label, **row}), cs.emit(rows[-1]))

    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    results = {"kernels": {}}
    with torch.no_grad():
        made = cs.phase_kernels(k5_cases(gen), results["kernels"])
        if args.key_tiles:
            default = fa._k5_key_tile
            try:
                for tile in (int(t) for t in args.key_tiles.split(",")):
                    fa._k5_key_tile = lambda *a, tile=tile: tile
                    made += cs.phase_kernels(k5_cases(gen, tile), results["kernels"])
            finally:
                fa._k5_key_tile = default
    with torch.inference_mode():
        made += cs.phase_kernels([cs.k2_case(gen, cs.K2_DECODE_M, 768, 2304)],
                                 results["kernels"])
    for row in made:
        rows.append({"label": args.label, **row})

    cs.phase_longctx(gen, results)
    for s, row in results["longctx"]["runs"].items():
        add({"case": f"longctx {s}", **{k: row[k] for k in ("batch", "flash_fwd",
                                                             "flash_fwd_bwd")}})

    for name, fn in (("train_einsum", train_einsum), ("train_8k", train_8k)):
        run = fn(gen)
        k5_ms, k5_names = k5_device_ms(run["profile"])
        add({"case": name, "step_ms": run["step_ms"], "step_ms_timed": run["step_ms_timed"],
             "tokens_per_s": run["tokens_per_s"], "mfu": run["mfu"],
             "device_ms": run["profile"]["device_ms"],
             "device_idle_share": run["profile"]["device_idle_share"],
             "k5_device_ms": k5_ms, "k5_kernels": k5_names,
             "k5_launches_per_step": run["launches_per_step"]["flash_attention_bwd"]})
        torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
