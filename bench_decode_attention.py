"""Compare K1 (the single-query decode attention, its (m, l) form K1-ml and
its redesigns) and the decode steps that carry it between two checkouts of
the port on one GPU.

    python3 bench_decode_attention.py [--tree DIR] [--label NAME] [--skip-models] [--out FILE]

Runs the port found under ``--tree`` (the root of a checkout; default: the
one this script lies in) through ``chip_smoke.py``'s own cases and runners,
imported from beside this script, so that two commits compare in one call:
unpack the other one with ``git archive`` into a directory that
``.gitignore`` lists and run parent, change, change, parent.

1. K1 and K1-ml at every shape the model paths launch them at, through
   ``chip_smoke.phase_kernels``: ``k1_cases`` (GPT rows E 1536, dk = dv =
   64, and the Backpack combine E 2048, dv 768, bf16 and int8, S 512,
   ragged lengths), ``decode_problem_cases``' K1 and its three redesigns
   (gathered; the selector over values transposed in the cache, and
   transposed by the wrapper; blockdiag) at the GPT and combine rows over
   INT8 caches of S 512 (full and ragged lengths, row 0 empty),
   ``ml_kernel_cases``' K1-ml (window 256 of 512, ragged base lengths),
   ``decode_long_cases``' gpt-generate shape (E 96, bf16, S 2112, lengths
   2048-2112) and S 16384 (lengths 8192-16384: K1 and K1-gathered at
   both), ``k1_serve_cases`` (every row at 64 under the 128 window and at
   224 under the 256 window, GPT and combine, int8) and
   ``decode_past_cap_cases`` at S 65,536 (E 96, bf16, row 0 empty: K1,
   K1-gathered and K1-blockdiag over one cache). Each: errors under the 2x
   rule, CUDA-event ms, profiler device ms with its recorded launches,
   host microseconds a call, the bound and SDPA's times.
2. The INT8 serve (backpack-small, INT8 weights and caches, 128 prompts of
   32 tokens, 224 greedy tokens, ``chip_smoke.serve_run`` and its decode
   profile): wall and device ms a decode step, K1's device ms and its
   recorded and counted launches a step, the idle share.
3. gpt-generate (rotary gpt3-small, batch 8, prompt 2048, 64 tokens, bf16
   cache, ``chip_smoke.phase_generate``): device ms a decode step and K1's.

``--skip-models`` leaves out 2 and 3. One JSON line each (the card's name
and power limit first); ``--out`` writes them all as one JSON list. Exits
non-zero without a card.
"""

import argparse
import json
import sys
from pathlib import Path

import torch

import chip_smoke as cs

K1_NAMES = ("decode_attention", "decode_attention_ml", "decode_attention_gathered",
            "decode_attention_selector", "decode_attention_blockdiag")


def k1_bench_cases(gen):
    """K1's and K1-ml's cases at the model paths' shapes (its redesigns at
    the decode-kernels phase's S 512, gpt-generate's, S 16384 and S
    65,536), each with device and host times."""
    cases = cs.k1_cases(gen)
    for shape, e, dk, dv in cs.DECODE_SHAPES:
        cases += [c for c in cs.decode_problem_cases(gen, shape, e, dk, dv, 512)
                  if c[0] in K1_NAMES]
    cases += [c for c in cs.ml_kernel_cases(gen) if c[0] == "decode_attention_ml"]
    cases += cs.decode_long_cases(gen)
    cases += cs.k1_serve_cases(gen)
    cases += cs.decode_past_cap_cases(("decode_attention", "decode_attention_gathered",
                                       "decode_attention_blockdiag"))
    for _, _, c in cases:
        c["device_times"] = True
    return [c for c in cases if c[0] in K1_NAMES]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parent)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--skip-models", action="store_true")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_decode_attention: no CUDA device", file=sys.stderr)
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
        cases = k1_bench_cases(gen)
        made = cs.phase_kernels(cases, {})
    lines += [{"label": args.label, "kernel": name, **row}
              for (name, _, _), row in zip(cases, made)]
    del cases
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
        run, _ = cs.serve_run("int8", qparams, cfg, "int8", prompt)
        cs._add_profile(run, qparams, cfg, prompt)
        del qparams
    steps = sum(n for n, _ in cs.SEGMENTS)
    prof = run["profile"]
    add({"case": "serve int8",
         "wall_ms_per_step": run["decode_s"] * 1e3 / steps,
         "tokens_per_s": run["tokens_per_s"],
         "device_ms_per_step": prof["device_ms_per_step"],
         "k1_device_ms_per_step": prof["k1_device_ms_per_step"],
         "k1_recorded_launches_per_step": prof["k1_recorded_launches_per_step"],
         "k1_launches_per_step": run["launches_per_decode_step"]["decode_attention"],
         "k2_device_ms_per_step": prof["k2_device_ms_per_step"],
         "device_idle_share": prof["device_idle_share"]})
    torch.cuda.empty_cache()

    results = {}
    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    cs.phase_gpt(gen, results, ["generate"])
    g = results["gpt_generate"]
    add({"case": "gpt-generate", "tokens_per_s": g["tokens_per_s"],
         "decode_tokens_per_s": g["decode_tokens_per_s"],
         "wall_ms_per_step_profiled": g["profile"]["wall_ms_per_step_profiled"],
         "device_ms_per_step": g["profile"]["device_ms_per_step"],
         "k1_device_ms_per_step": g["profile"]["k1_device_ms_per_step"],
         "k1_recorded_launches_per_step": g["profile"]["k1_recorded_launches_per_step"],
         "k1_launches_per_step": g["launches_per_decode_step"],
         "device_idle_share": g["profile"]["device_idle_share"]})
    _write(args, lines)


def _write(args, lines):
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(lines, indent=1))


if __name__ == "__main__":
    main()
