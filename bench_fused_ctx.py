"""Compare K4 (the fused Backpack contextualization forward) and the runs
that carry it between two checkouts of the port on one GPU.

    python3 bench_fused_ctx.py [--tree DIR] [--label NAME] [--rows 64,128] [--out FILE]

Runs the port found under ``--tree`` (the root of a checkout; default: the
one this script lies in) through ``chip_smoke.py``'s own cases and runners,
imported from beside this script, so that two commits compare in one call:
unpack the other one with ``git archive`` into a directory that
``.gitignore`` lists and run parent, change, change, parent.

1. K4 at the forward's shape (8 x 512) and the training shape (32 x 512),
   nv 16, dnv 48, d 768, bf16, q and k strided views of one packed tensor
   as the model makes them, and at backpack-mini's widths (8 x 512, dnv 40,
   d 640), through ``chip_smoke.k4_case`` and ``phase_kernels``: errors
   under the 2x rule, one launch a call, CUDA-event ms, profiler device ms
   and host microseconds a call, each beside SDPA per sense head summed,
   and the bound; then the device ms a call of each kernel of the launch
   (the LSE pass and the product apart). ``--rows`` (a tree whose wrapper
   has ``_k4_rows``) repeats the cases at each forced query-row tiling.
2. forward-bf16: ``chip_smoke.phase_forward`` three times (backpack-small,
   8 x 512, K3 and K4; tokens/s of one timed forward each).
3. train-fused: backpack-small at 32 x 512 with the fused combine (K4
   forward, K6 backward), 12 steps through ``chip_smoke.train_run``
   (median of the 10 after 2 warm-up), with K4's and K6's device ms in the
   profiled step.

One JSON line each (the card's name and power limit first); ``--out``
writes them all as one JSON list. Exits non-zero without a card.
"""

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

import chip_smoke as cs

# the kernels of K4 (the parent's and this tree's) and of K6, by name
K4_KERNELS = ("ctx_lse_kernel", "ctx_pv_kernel", "ctx_wgmma_kernel", "fused_ctx_simt_kernel")
K6_KERNELS = ("dq_kernel", "dk_kernel", "dc_kernel")


def _base(name):
    return name.removeprefix("void ").split("::", 1)[-1].split("(")[0].split("<")[0]


def kernel_split(fn, reps=cs.REPS):
    """Device ms a call of each kernel fn launches (torch.profiler, the L2
    flushed before each call, the flush's own kernel left out)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            cs.flush_l2()
            fn()
        torch.cuda.synchronize()
    return {ev.key[:80]: ev.self_device_time_total / 1e3 / reps
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.count
            and "fill" not in ev.key.lower()}


def step_device_ms(profile, names):
    """Device ms of the kernels in ``names`` in one profiled step."""
    found = {}
    for row in profile["port"]:
        if _base(row["name"]) in names:
            found[row["name"]] = found.get(row["name"], 0.0) + row["ms"]
    return sum(found.values()), found


def k4_cases(gen, tag=""):
    randn = lambda *s: torch.randn(*s, generator=gen, device=cs.DEV)
    bf = torch.bfloat16
    cases = []
    for b in (cs.FWD_BATCH, cs.TRAIN_BATCH):
        qk = randn(b, 512, 2, 16, 48).to(bf)
        cases.append(cs.k4_case(tag, qk[:, :, 0], qk[:, :, 1], randn(b, 512, 16, 768).to(bf)))
    qk = randn(8, 512, 2, 16, 40).to(bf)
    cases.append(cs.k4_case(f"{tag}mini ", qk[:, :, 0], qk[:, :, 1],
                            randn(8, 512, 16, 640).to(bf)))
    return cases


def run_k4(gen, lines, add, tag=""):
    cases = k4_cases(gen, tag)
    made = cs.phase_kernels(cases, {})
    for (_, _, c), row in zip(cases, made):
        lines.append({"label": lines[0]["label"], **row})
        add({"case": row["case"], "kernels_device_ms": kernel_split(c["kernel"])})
    del cases
    torch.cuda.empty_cache()


def train_fused(gen):
    """backpack-small, the fused combine, 32 x 512 on the bigram corpus."""
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
    check = lambda c: (None if c["fused_contextualization"] == 1
                       and c["fused_contextualization_bwd"] == 1
                       else f"K4/K6 launches {c['fused_contextualization']}/"
                            f"{c['fused_contextualization_bwd']}, want 1 each")
    run, _ = cs.train_run("train_fused", cfg, params, batches,
                          tl.make_train_step(cfg, fused_ctx=True), check, fused_ctx=True)
    return run


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parent)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--rows", default="")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_fused_ctx: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(args.tree.resolve()))
    from backpacks_flash_attn_tpu_torch.ops import _build
    from backpacks_flash_attn_tpu_torch.ops import backpack_kernels as bk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lines = [{"label": args.label, "tree": str(args.tree), "nvidia_smi": cs.nvidia_smi_line(),
             "device": torch.cuda.get_device_name(0), "package": _build.__file__}]
    cs.emit(lines[0])
    _build.build_all()
    add = lambda row: (lines.append({"label": args.label, **row}), cs.emit(lines[-1]))

    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    with torch.inference_mode():
        run_k4(gen, lines, add)
        if args.rows:
            default = bk._k4_rows
            try:
                for forced in (int(r) for r in args.rows.split(",")):
                    bk._k4_rows = lambda *a, forced=forced: forced
                    run_k4(gen, lines, add, f"rows={forced} ")
            finally:
                bk._k4_rows = default

    fwd = {}
    for _ in range(3):
        with torch.inference_mode():
            cs.phase_forward(gen, fwd)
        lines.append({"label": args.label, "case": "forward", **fwd["forward"]})
        torch.cuda.empty_cache()
    tps = [r["tokens_per_s"] for r in lines if r.get("case") == "forward"]
    add({"case": "forward summary", "tokens_per_s": tps,
         "tokens_per_s_median": statistics.median(tps)})

    run = train_fused(gen)
    k4_ms, k4_names = step_device_ms(run["profile"], K4_KERNELS)
    k6_ms, k6_names = step_device_ms(run["profile"], K6_KERNELS)
    add({"case": "train_fused", "step_ms": run["step_ms"], "step_ms_timed": run["step_ms_timed"],
         "tokens_per_s": run["tokens_per_s"], "mfu": run["mfu"],
         "device_ms": run["profile"]["device_ms"],
         "device_idle_share": run["profile"]["device_idle_share"],
         "k4_device_ms": k4_ms, "k4_kernels": k4_names,
         "k6_device_ms": k6_ms, "k6_kernels": k6_names,
         "launches_per_step": {k: run["launches_per_step"][k] for k in (
             "fused_contextualization", "fused_contextualization_bwd")}})
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(lines, indent=1))


if __name__ == "__main__":
    main()
