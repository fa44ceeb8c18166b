"""Compare K8 (the low-bit decode attention over int4 or split int8 keys and
int4 values, and its (m, l) form K8-ml) and the low-bit decode steps that
carry it between two checkouts of the port on one GPU.

    python3 bench_lowbit_decode.py [--tree DIR] [--label NAME] [--skip-models] [--out FILE]

Runs the port found under ``--tree`` (the root of a checkout; default: the
one this script lies in) through ``chip_smoke.py``'s own cases and runners,
imported from beside this script, so that two commits compare in one call:
unpack the other one with ``git archive`` into a directory that
``.gitignore`` lists and run parent, change, change, parent.

1. K8 and K8-ml at every shape chip_smoke runs them at, through
   ``chip_smoke.phase_kernels``, one case at a time: ``k8_cases`` (int4
   keys at the GPT rows, E 1536, dk = dv = 64, window 256 of a 512 cache;
   split int8 keys at the Backpack combine, E 2048, dv 768, S 512; ragged
   lengths), ``ml_kernel_cases``' K8-ml (window 256 of 512, ragged base
   lengths, one empty), ``decode_problem_cases``' direct entries at S 512
   (GPT rows and combine, int4 and mixed, full lengths and ragged with row
   0 empty), ``k8_serve_cases`` (every row at 64 under the 128 window and
   at 224 under the 256 window) and ``k8_long_cases`` (E 96, S 16384,
   past the old cap: a tree that refuses it records the error). Each:
   errors under the 2x rule, CUDA-event ms, profiler device ms with its
   recorded launches, host microseconds a call, the bound and SDPA's
   times.
2. serve-kv4 and serve-int4 (backpack-small, INT8 weights over the int4
   GPT KV with INT8 or mixed ctx-K and senses, 128 prompts of 32 tokens,
   224 greedy tokens; ``chip_smoke.serve_run`` and its 32-step decode
   profile) and serve-staged-kv4 (``chip_smoke.staged_kv4_run``): wall and
   device ms a decode step, K8's and K1's device ms and recorded launches
   a step, the counted launches, the idle share.

``--skip-models`` leaves out 2. One JSON line each (the card's name and
power limit first); ``--out`` writes them all as one JSON list. Exits
non-zero without a card.
"""

import argparse
import json
import sys
from pathlib import Path

import torch

import chip_smoke as cs

K8_NAMES = ("lowbit_decode_int4", "lowbit_decode_mixed", "lowbit_decode_int4_ml")


def k8_bench_cases(gen):
    """K8's and K8-ml's cases at chip_smoke's shapes, each with device and
    host times."""
    cases = cs.k8_cases(gen)
    cases += [c for c in cs.ml_kernel_cases(gen) if c[0] in K8_NAMES]
    for shape, e, dk, dv in cs.DECODE_SHAPES:
        cases += [c for c in cs.decode_problem_cases(gen, shape, e, dk, dv, 512)
                  if c[0] in K8_NAMES]
    cases += cs.k8_serve_cases(gen) + cs.k8_long_cases(gen)
    for _, _, c in cases:
        c["device_times"] = True
    return cases


def _step_row(label, run):
    prof = run["profile"]
    return {"case": label, "tokens_per_s": run["tokens_per_s"],
            "wall_ms_per_step": prof["wall_ms_per_step"],
            "device_ms_per_step": prof["device_ms_per_step"],
            "k8_device_ms_per_step": prof["k8_device_ms_per_step"],
            "k8_recorded_launches_per_step": prof["k8_recorded_launches_per_step"],
            "k1_device_ms_per_step": prof["k1_device_ms_per_step"],
            "k1_recorded_launches_per_step": prof["k1_recorded_launches_per_step"],
            "launches_per_step": {k: v for k, v in run["launches_per_decode_step"].items()
                                  if k in K8_NAMES + ("decode_attention", "decode_attention_ml")},
            "device_idle_share": prof["device_idle_share"]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parent)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--skip-models", action="store_true")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_lowbit_decode: no CUDA device", file=sys.stderr)
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
    with torch.inference_mode():
        for case in k8_bench_cases(gen):
            try:
                made = cs.phase_kernels([case], {})
            except (RuntimeError, ValueError) as exc:   # a tree that refuses the shape
                add({"kernel": case[0], "case": case[1], "error": str(exc)[:300]})
                continue
            lines += [{"label": args.label, **row} for row in made]
        torch.cuda.empty_cache()
    if args.skip_models:
        return _write(args, lines)

    from backpacks_flash_attn_tpu_torch.config import backpack_small
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    from backpacks_flash_attn_tpu_torch.models import quantized as qz

    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    cfg = backpack_small(vocab_size=50257)
    with torch.inference_mode():
        params = bp.init_backpack(cfg, gen, dtype=torch.bfloat16)
        prompt = torch.randint(0, cfg.vocab_size, (cs.BATCH, cs.PROMPT), generator=gen,
                               device=cs.DEV)
        qparams = qz.quantize_backpack_params(params, cfg, bits=8)
        del params
        for cache in ("kv4", "int4"):
            run, _ = cs.serve_run(cache, qparams, cfg, cache, prompt)
            cs._check_lowbit_launches(run, cfg)
            cs._add_profile(run, qparams, cfg, prompt, cs.SHORT_PROFILE)
            add(_step_row(f"serve {cache}", run))
        run = cs.staged_kv4_run(qparams, cfg, prompt)
        add(_step_row("serve staged-kv4", run))
    _write(args, lines)


def _write(args, lines):
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(lines, indent=1))


if __name__ == "__main__":
    main()
