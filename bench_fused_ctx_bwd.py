"""Compare K6 (the fused Backpack contextualization backward) and the
train-fused step that carries it between two checkouts of the port on one
GPU.

    python3 bench_fused_ctx_bwd.py [--tree DIR] [--label NAME] [--skip-train] [--out FILE]

Runs the port found under ``--tree`` (the root of a checkout; default: the
one this script lies in) through ``chip_smoke.py``'s own cases and runners,
imported from beside this script, so that two commits compare in one call:
unpack the other one with ``git archive`` into a directory that
``.gitignore`` lists and run parent, change, change, parent.

1. K6 at the training shape (32 x 512, nv 16, dnv 48, d 768) and at
   backpack-mini's widths (8 x 512, nv 16, dnv 40, d 640), bf16, q and k
   strided views of one packed tensor as the model makes them, each
   backward from K4's LSE, through ``chip_smoke.k6_case`` and
   ``phase_kernels``: errors under the 2x rule, one launch count a call,
   CUDA-event ms, profiler device ms and host microseconds a call, each
   beside SDPA's backward per sense head (summed over the heads), and the
   bound; then the device ms and the recorded launches a call of each
   kernel the launch runs.
2. train-fused: backpack-small at 32 x 512 with the fused combine (K4
   forward, K6 backward), 12 steps through ``chip_smoke.train_run``
   (median of the 10 after 2 warm-up), with K4's and K6's device ms in the
   profiled step (``--skip-train`` leaves it out).

One JSON line each (the card's name and power limit first); ``--out``
writes them all as one JSON list. Exits non-zero without a card.
"""

import argparse
import json
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from bench_fused_ctx import K4_KERNELS, K6_KERNELS, kernel_split, step_device_ms, train_fused


def k6_cases(gen):
    randn = lambda *s: torch.randn(*s, generator=gen, device=cs.DEV)
    bf = torch.bfloat16
    cases = []
    for b, nv, dnv, d in ((cs.TRAIN_BATCH, 16, 48, 768), (8, 16, 40, 640)):
        qk = randn(b, 512, 2, nv, dnv).to(bf)
        c = randn(b, 512, nv, d).to(bf)
        g = randn(b, 512, d).to(bf)
        cases.append(cs.k6_case("mini " if d == 640 else "train ", qk[:, :, 0], qk[:, :, 1],
                                c, g))
    return cases


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parent)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_fused_ctx_bwd: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(args.tree.resolve()))
    from backpacks_flash_attn_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lines = [{"label": args.label, "tree": str(args.tree), "nvidia_smi": cs.nvidia_smi_line(),
              "device": torch.cuda.get_device_name(0), "package": _build.__file__}]
    cs.emit(lines[0])
    _build.build_all()
    add = lambda row: (lines.append({"label": args.label, **row}), cs.emit(lines[-1]))

    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    with torch.no_grad():
        cases = k6_cases(gen)
        made = cs.phase_kernels(cases, {})
        for (_, _, c), row in zip(cases, made):
            lines.append({"label": args.label, **row})
            add({"case": row["case"], "kernels_device_ms": kernel_split(c["kernel"])})
        del cases
    torch.cuda.empty_cache()

    if not args.skip_train:
        run = train_fused(gen)
        k4_ms, k4_names = step_device_ms(run["profile"], K4_KERNELS)
        k6_ms, k6_names = step_device_ms(run["profile"], K6_KERNELS)
        add({"case": "train_fused", "step_ms": run["step_ms"],
             "step_ms_timed": run["step_ms_timed"], "tokens_per_s": run["tokens_per_s"],
             "mfu": run["mfu"], "device_ms": run["profile"]["device_ms"],
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
