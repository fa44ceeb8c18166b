"""Locate K1-gathered's time on the card at few rows (its length-balanced
launch): build variants of ``csrc/decode_attention_gathered.cu`` with one
part taken out, and time it under other launch shapes.

    python3 probe_gathered.py [--variants NAME,...] [--out FILE]

Source variants (text substitutions in ``csrc/decode_attention_gathered.cu``
and the header ``csrc/decode_attention.cuh``, each built with the package's
nvcc flags into ``build/probe_gathered/NAME/`` and swapped in as the
gathered form's library; ``probe_k1.variant_source`` and ``probe_k1.build``):

    full          the kernel as it is
    scan_only     every CTA returns after its prefix scan: the launch, the
                  lengths' reads and the scan alone
    copies_only   no q . k and no p @ v products: the scan, the copies, the
                  ring's waits, the softmax bookkeeping, partials and merge
    no_merge      no ticket and no row merge (a split row's partials are
                  written and left)
    fence_thread0 one __threadfence by the ticket's thread after the CTA's
                  barrier, instead of one by every thread before it

Launch shapes (the full kernel, ``_gathered_schedule`` replaced for the
call): CTAs an SM (1, 2, 3) and ring stages (2, 3, 4) where they fit, at 8
warps a CTA and at 4.

Shapes: gpt-generate's decode (E 96, dk = dv = 64, bf16, S 2112, lengths
2048-2112) and S 16384 (lengths 8192-16384): device ms a call
(torch.profiler, L2 flushed by chip_smoke's zeroing) beside the byte
bound and K1's (its own launch) at the same shape. A variant's numbers say
where the time goes, not that its output is right. One JSON line a timing,
the card's name and power limit first, and ptxas's registers and spills of
each variant's instances. Exits non-zero without a card.
"""

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

import chip_smoke as cs
import probe_k1
from backpacks_flash_attn_tpu_torch.ops import _build
from backpacks_flash_attn_tpu_torch.ops import decode_attention as da

SOURCES = (_build.CSRC / "decode_attention_gathered.cu", _build.CSRC / "decode_attention.cuh")
OUT_DIR = _build.BUILD_DIR.parent / "probe_gathered"
SCAN_END = "  __syncthreads();  // read before the first copies land there\n"
FENCE_ALL = """        __threadfence();
        __syncthreads();
        const int c0 = cta_of(rs), segs = cta_of(rs + nt - 1) - c0 + 1;
        int* last = reinterpret_cast<int*>(smem + L.q_off);  // q is read by now
        if (gt == 0) *last = atomicAdd(tickets + r, 1) == segs - 1;"""

VARIANTS = {
    "full": [],
    "scan_only": [(SCAN_END, SCAN_END + "  if (c >= 0) return;\n")],
    "copies_only": [probe_k1.NO_SCORES, probe_k1.NO_VALUES],
    "no_merge": [("if (gt == 0) *last = atomicAdd(tickets + r, 1) == segs - 1;",
                  "if (gt == 0) *last = 0;")],
    "fence_thread0": [(FENCE_ALL, """        __syncthreads();
        const int c0 = cta_of(rs), segs = cta_of(rs + nt - 1) - c0 + 1;
        int* last = reinterpret_cast<int*>(smem + L.q_off);  // q is read by now
        if (gt == 0) {
          __threadfence();
          *last = atomicAdd(tickets + r, 1) == segs - 1;
        }""")],
}


def shapes(gen):
    """(label, args, bytes) of the probed calls: chip_smoke's gpt-generate
    and S 16384 decode shapes."""
    bf, dev = torch.bfloat16, cs.DEV
    out = []
    for label, s, lo in (("gpt-generate bf16 S2112", cs.GEN_WIDTH, cs.GEN_PROMPT),
                         ("long bf16 S16384", cs.DECODE_LONG_S, cs.DECODE_LONG_S // 2)):
        e = cs.GEN_ROWS
        q = (torch.randn(e, 64, generator=gen, device=dev) * 0.125).to(bf)
        kt = torch.randn(e, 64, s, generator=gen, device=dev).to(bf)
        v = torch.randn(e, s, 64, generator=gen, device=dev).to(bf)
        lens = torch.randint(lo, s + 1, (e,), generator=gen, device=dev, dtype=torch.int32)
        n = int(lens.sum().item())
        out.append((label, (q, kt, None, v, None, lens), q.numel() * 2 + n * 256 + e * 64 * 2))
    return out


def schedules(args):
    """(name, schedule) overrides of the full kernel: CTAs an SM and ring
    stages at 8 and 4 warps a CTA, where the rings fit an SM."""
    q, kt, _, v, _, _ = args
    e, s, dv, elt = q.shape[0], v.shape[1], v.shape[2], kt.element_size()
    sms = _build.sm_count(0)
    base = da._gathered_schedule(e, 64, dv, s, elt, sms)
    qpl = base[0]
    out = []
    for warps in (8, 4):
        for per_sm in (1, 2, 3, 4):
            for st in (2, 3, 4):
                group = da._k1_group_bytes(qpl, 64, dv, elt, warps, st) + 1024
                grid = sms * per_sm
                sched = (qpl, warps, st, grid, (grid + e - 1) * (4 + -(-dv // 4) * 4))
                if per_sm * group <= 233472 and sched != base:
                    out.append((f"w{warps} per_sm={per_sm} stages={st}", sched))
    return base, out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_gathered: no CUDA device", file=sys.stderr)
        sys.exit(2)
    rows = [{"nvidia_smi": cs.nvidia_smi_line(), "device": torch.cuda.get_device_name(0)}]
    cs.emit(rows[0])
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    _build.build_all(["decode_attention", "decode_attention_gathered"])
    sources = {n: probe_k1.variant_source(n, VARIANTS[n], SOURCES)
               for n in args.variants.split(",")}
    libs = {}
    for name, lib, proc in [probe_k1.build(n, text, OUT_DIR) for n, text in sources.items()]:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build:\n{log}")
        libs[name] = lib
        rows.append({"variant": name,
                     "ptxas": probe_k1.ptxas_summary(log, "decode_gathered_kernel")})
        cs.emit(rows[-1])

    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    calls = shapes(gen)
    kernel = _build.KERNELS["decode_attention_gathered"]
    default_lib, default_schedule = kernel.lib, da._gathered_schedule
    emit = lambda row: (rows.append(row), cs.emit(row))
    try:
        with torch.inference_mode():
            for label, a, nbytes in calls:
                ms, launches = cs.device_ms(lambda a=a: da.decode_attention(*a))
                emit({"variant": "K1", "shape": label, "device_ms": ms,
                      "recorded_launches": launches,
                      "bound_ms": nbytes / cs.PEAK_BYTES_PER_S * 1e3})
            for name, path in libs.items():
                lib = ctypes.CDLL(str(path))
                lib.kernel_error_string.argtypes = [ctypes.c_int]
                lib.kernel_error_string.restype = ctypes.c_char_p
                kernel.lib = lib
                for label, a, nbytes in calls:
                    base, others = schedules(a)
                    for sname, sched in [("default", base)] + (others if name == "full" else []):
                        da._gathered_schedule = lambda *_, s=sched: s
                        ms, launches = cs.device_ms(lambda a=a: da.decode_attention_gathered(*a))
                        emit({"variant": name, "shape": label, "schedule": sname,
                              "launch_shape": list(sched[:4]), "device_ms": ms,
                              "recorded_launches": launches,
                              "bound_ms": nbytes / cs.PEAK_BYTES_PER_S * 1e3})
                    da._gathered_schedule = default_schedule
    finally:
        kernel.lib = default_lib
        da._gathered_schedule = default_schedule
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
