"""Compare K2 (the INT8/INT4 weight-dequant GEMM) and the INT8 serve loop
between two checkouts of the port on one GPU.

    python3 bench_quant_matmul.py [--tree DIR] [--label NAME] [--out FILE]

Runs the port found under ``--tree`` (the root of a checkout; default: the
one this script lies in) through ``chip_smoke.py``'s own cases and
yardsticks, imported from beside this script, so that two commits compare
in one call: unpack the other one with ``git archive`` into a directory
that ``.gitignore`` lists and run parent, change, change, parent.

1. K2 at ``chip_smoke.py``'s decode shapes (M 128: the step's six, and the
   serve's own lm-head width, 50257 columns) and prefill shapes (M 4096),
   INT8 per-channel, through its ``phase_kernels``: errors under the 2x
   rule, one launch a call, CUDA-event ms, profiler device ms and host
   microseconds a call, each beside torch.matmul's on the bf16 weight; then
   its "K2 a decode step" sums over the step's 50 launches.
2. The INT8 serve: backpack-small with INT8 weights and caches, random
   weights from a seeded generator, through ``chip_smoke.py``'s
   ``serve_run`` (128 prompts of 32 tokens, 224 greedy tokens, the median
   of 3 passes) and its decode profile: wall and device ms a decode step,
   K2's device ms among them, the idle share.

One JSON line each (the card's name and power limit first); ``--out``
writes them all as one JSON list. Exits non-zero without a card.
"""

import argparse
import json
import sys
from pathlib import Path

import torch

import chip_smoke as cs

SERVE_LM_HEAD = (768, 50257)   # the serve's vocabulary: an odd row stride


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parent)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_quant_matmul: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(args.tree.resolve()))
    from backpacks_flash_attn_tpu_torch.config import backpack_small
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    from backpacks_flash_attn_tpu_torch.models import quantized as qz
    from backpacks_flash_attn_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = [{"label": args.label, "tree": str(args.tree), "nvidia_smi": cs.nvidia_smi_line(),
             "device": torch.cuda.get_device_name(0), "package": _build.__file__}]
    cs.emit(rows[0])
    _build.build_all()

    results = {"kernels": {}}
    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    shapes = [(cs.K2_DECODE_M, k, n) for k, n in [*cs.K2_DECODE_STEP, SERVE_LM_HEAD]]
    shapes += [(cs.K2_PREFILL_M, k, n) for k, n, _, _ in cs.K2_SHAPES]
    with torch.inference_mode():
        made = cs.phase_kernels([cs.k2_case(gen, *shape) for shape in shapes],
                                results["kernels"])
    cs.k2_decode_step(results)
    rows += [{"label": args.label, **row} for row in made]
    rows.append({"label": args.label, "case": "decode step (50 launches)",
                 **results["k2_decode_step"]})

    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    cfg = backpack_small(vocab_size=50257)
    with torch.inference_mode():
        params = bp.init_backpack(cfg, gen, dtype=torch.bfloat16)
        prompt = torch.randint(0, cfg.vocab_size, (cs.BATCH, cs.PROMPT), generator=gen,
                               device=cs.DEV)
        qparams = qz.quantize_backpack_params(params, cfg, bits=8)
        del params
        run, _ = cs.serve_run("int8", qparams, cfg, "int8", prompt)
        cs._add_profile(run, qparams, cfg, prompt)
    steps = sum(n for n, _ in cs.SEGMENTS)
    prof = run["profile"]
    serve = {"label": args.label, "case": "serve int8",
             "wall_ms_per_step_passes": [t * 1e3 / steps for t in run["decode_s_passes"]],
             "wall_ms_per_step": run["decode_s"] * 1e3 / steps,
             "tokens_per_s": run["tokens_per_s"],
             "device_ms_per_step": prof["device_ms_per_step"],
             "k2_device_ms_per_step": prof["k2_device_ms_per_step"],
             "device_idle_share": prof["device_idle_share"],
             "k2_launches_per_step": run["launches_per_decode_step"]["quant_matmul"]}
    rows.append(serve)
    cs.emit(serve)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
