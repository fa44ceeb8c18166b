"""Locate K1-selector's time on the card: build variants of
``csrc/decode_attention_selector.cu`` with one part taken out, and time the
selector under other launch shapes, beside K1 over the same cache.

    python3 probe_selector.py [--variants NAME,...] [--out FILE]

Source variants (text substitutions in ``csrc/decode_attention_selector.cu``
and the header ``csrc/decode_attention.cuh``, each built with the
package's nvcc flags into ``build/probe_selector/NAME/`` and swapped in as
the selector's library by ``probe_k1.build``):

    full             the kernel as it is
    no_loads         no copy into the ring (the tiles hold whatever is there)
    no_value_copies  the keys and scales copied, the value channel rows not
    no_values        no p @ v products (the value tiles still copied)
    no_swizzle       value chunks unswizzled (the lanes of a load on one bank)
    wide_t16         a warp's slice of 16 bytes of keys a d row for wide rows
                     (8 as built), so 16-byte value units and channel runs
                     twice as long

Launch shapes (the full kernel and wide_t16, ``_k1_schedule`` replaced for
the call): (warps, rows) a CTA of (4, 1), (8, 1), (8, 2) and (4, 2) at 2 and
3 stages where they fit. A wide row's channel run is (warps / rows) x 8
bytes of int8 (x 16 with wide_t16).

Shapes: the decode-kernels phase's GPT rows (E 1536, dk = dv = 64, S 512,
full lengths) and Backpack combine (E 2048, dv 768, S 512, full and ragged
lengths), INT8 caches with the values (E, dv, S): device ms a call
(torch.profiler, the L2 flushed) beside the byte bound, and K1 over the
same cache in K1's (E, S, dv) layout. A variant's numbers say where the
time goes, not that its output is right. One JSON line a timing, the
card's name and power limit first, and ptxas's registers and spills of
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

SOURCES = (_build.CSRC / "decode_attention_selector.cu", _build.CSRC / "decode_attention.cuh")
OUT_DIR = _build.BUILD_DIR.parent / "probe_selector"
KERNEL = "decode_selector_kernel"

VARIANTS = {
    "full": [],
    "no_loads": [("  auto load = [&](int slot, int tile) {\n",
                  "  auto load = [&](int slot, int tile) {\n    if (slot >= 0) return;\n")],
    "no_value_copies": [("      for (int i = gt; i < a.dv << kcs; i += gthreads) {",
                         "      for (int i = gt; i < 0; i += gthreads) {")],
    "no_values": [("  for (int u = ps0; u < nu && u * UP < nv; u += PS) {",
                   "  for (int u = ps0; u < 0; u += PS) {")],
    "no_swizzle": [("  const int vm = min(KCv, 8) - 1,", "  const int vm = 0 * KCv,")],
    "wide_t16": probe_k1._tile(32, 16),
}
# the launch shapes tried beside the schedule's: (warps, rows) at 2 and 3 stages
SHAPES = ((4, 1), (8, 1), (8, 2), (4, 2))


def shapes(gen):
    """(label, selector args, K1 args, bytes) of the probed calls."""
    dev, out = cs.DEV, []
    for label, e, dv, ragged in (("gpt_kv int8 S512 full", 1536, 64, False),
                                 ("combine int8 S512 full", 2048, 768, False),
                                 ("combine int8 S512 ragged", 2048, 768, True)):
        s = 512
        q = (torch.randn(e, 64, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
        kt = torch.randint(-127, 128, (e, 64, s), generator=gen, device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, (e, s, dv), generator=gen, device=dev, dtype=torch.int8)
        ks, vs = torch.rand(2, e, s, generator=gen, device=dev) * 0.05
        lens = (torch.randint(1, s + 1, (e,), generator=gen, device=dev, dtype=torch.int32)
                if ragged else torch.full((e,), s, dtype=torch.int32, device=dev))
        n = int(lens.sum().item())
        vt = v.transpose(1, 2).contiguous()
        out.append((label, (q, kt, ks, vt, vs, lens), (q, kt, ks, v, vs, lens),
                    q.numel() * 2 + n * (64 + dv + 8) + e * dv * 2 + e * 4))
    return out


def schedules(sel_args, tw):
    """The schedule's launch shape and the others of SHAPES that fit, for a
    wide row's slice of ``tw`` columns (8 as built, 16 with wide_t16)."""
    q, kt, _, vt, _, _ = sel_args
    e, dv, s = q.shape[0], vt.shape[1], vt.shape[2]
    base = da._k1_schedule(e, 64, dv, s, 1, _build.sm_count(0), True)
    qpl, split = base[0], base[3]
    extra = tw - da._k1_warp_tile(qpl, 1) if qpl > 1 else 0
    group = lambda wr, st: (da._k1_group_bytes(qpl, 64, dv, 1, wr, st, vt=True)
                            + st * (dv + 64 + 8) * extra * wr + 4 * extra * wr)
    out = []
    for w, r in SHAPES:
        for st in (2, 3):
            sched = (qpl, w, r, split, st)
            if sched != base and r * group(w // r, st) <= 232448:
                out.append((f"w{w}r{r}s{st}", sched))
    return base, out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_selector: no CUDA device", file=sys.stderr)
        sys.exit(2)
    rows = [{"nvidia_smi": cs.nvidia_smi_line(), "device": torch.cuda.get_device_name(0)}]
    cs.emit(rows[0])
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    _build.build_all(["decode_attention", "decode_attention_selector"])
    libs = {}
    sources = {n: probe_k1.variant_source(n, VARIANTS[n], SOURCES)
               for n in args.variants.split(",")}
    for name, lib, proc in [probe_k1.build(n, text, OUT_DIR) for n, text in sources.items()]:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build:\n{log}")
        libs[name] = lib
        rows.append({"variant": name, "ptxas": probe_k1.ptxas_summary(log, KERNEL)})
        cs.emit(rows[-1])

    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    calls = shapes(gen)
    kernel = _build.KERNELS["decode_attention_selector"]
    default_lib, default_schedule = kernel.lib, da._k1_schedule
    emit = lambda row: (rows.append(row), cs.emit(row))
    try:
        with torch.inference_mode():
            for label, _, k1_args, nbytes in calls:
                call = lambda a=k1_args: da.decode_attention(*a)
                emit({"variant": "k1", "shape": label, "schedule": "default",
                      "device_ms": cs.device_ms(call)[0],
                      "bound_ms": nbytes / cs.PEAK_BYTES_PER_S * 1e3})
            for name, path in libs.items():
                lib = ctypes.CDLL(str(path))
                lib.kernel_error_string.argtypes = [ctypes.c_int]
                lib.kernel_error_string.restype = ctypes.c_char_p
                kernel.lib = lib
                for label, a, _, nbytes in calls:
                    base, others = schedules(a, 16 if name == "wide_t16" else 8)
                    tried = [("default", base)] + (others if name in ("full", "wide_t16") else [])
                    for sname, sched in tried:
                        da._k1_schedule = lambda *_, s=sched: s
                        call = lambda a=a: da.decode_attention_selector(*a, v_transposed=True)
                        try:
                            ms, launches = cs.device_ms(call)
                        except RuntimeError as err:     # a launch shape the kernel refuses
                            emit({"variant": name, "shape": label, "schedule": sname,
                                  "error": str(err)})
                            continue
                        emit({"variant": name, "shape": label, "schedule": sname,
                              "launch_shape": list(sched), "device_ms": ms,
                              "recorded_launches": launches,
                              "bound_ms": nbytes / cs.PEAK_BYTES_PER_S * 1e3})
                    da._k1_schedule = default_schedule
    finally:
        kernel.lib = default_lib
        da._k1_schedule = default_schedule
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
