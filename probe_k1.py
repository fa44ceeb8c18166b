"""Locate K1's time on the card: build variants of
``csrc/decode_attention.cu`` with one part taken out, and time K1 under
other launch shapes, at the shapes the model paths launch it at.

    python3 probe_k1.py [--variants NAME,...] [--out FILE]

Source variants (text substitutions in ``csrc/decode_attention.cu`` and
the header ``csrc/decode_attention.cuh`` that holds the kernel's body,
each built with the package's nvcc flags into ``build/probe_k1/NAME/`` and
swapped in as K1's library):

    full        the kernel as it is
    no_loads    no copy into the ring (the tiles hold whatever is there)
    no_scores   no q . k products (scores 0)
    no_values   no p @ v products
    no_math     neither products: the copies, the ring's waits, the
                softmax bookkeeping and the merge
    narrow_t16, narrow_t64, wide_t16, wide_t4
                a warp's slice of 16 or 64 bytes of keys a d row for
                narrow rows, 16 or 4 for wide ones (32 and 8 as built);
                the ring's stages as the schedule picks them for the
                built slices
    no_vflat    value tiles of packed rows copied by the strided walk
    guarded_values  every value quad guarded (as where dv leaves lanes
                short)
    no_swizzle  key chunks unswizzled
    always_rescale  the accumulators rescaled every tile, the max moved or
                not
    int8_cvt_cheap  int8 words reinterpreted instead of converted (three
                xors for the __byte_perm/subtraction pairs)

Launch shapes (the full kernel, ``_k1_schedule`` replaced for the call):
each other ring depth (2, 3, 4 stages); (warps, rows) a CTA of (8, 8),
(8, 4), (8, 2), (8, 1), (4, 1), (4, 2) and (2, 1) at 2 and 3 stages where
they fit; at gpt-generate's rows each other cluster size (1, 2, 4, 8).

Shapes: the INT8 serve's GPT rows (E 1536, dk = dv = 64, S 512, full
lengths), its Backpack combine (E 2048, dv 768, S 512, ragged lengths; and
every row at 64 under the 128 window, at 224 under the 256 window; and
K1-ml's over the serve-engine's 256 window, ragged base lengths) and
gpt-generate's rows (E 96, bf16, S 2112, lengths 2048-2112): device ms a
call (torch.profiler; the L2 flushed by chip_smoke's zeroing, and again
by its clean read flush) beside the byte bound. A variant's
numbers say where the time goes, not that its output is right. One JSON
line a timing, the card's name and power limit first, and ptxas's
registers and spills of each variant's instances. Exits non-zero without a
card.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from backpacks_flash_attn_tpu_torch.ops import _build
from backpacks_flash_attn_tpu_torch.ops import decode_attention as da

# the kernel's entry file and the header that holds its body
SOURCES = (_build.CSRC / "decode_attention.cu", _build.CSRC / "decode_attention.cuh")
OUT_DIR = _build.BUILD_DIR.parent / "probe_k1"
NO_SCORES = ("      for (int d = g; d < a.dk; d += G) {", "      for (int d = g; d < 0; d += G) {")
NO_VALUES = ("  for (int s = ps0; s < nv; s += PS) {", "  for (int s = ps0; s < 0; s += PS) {")
def _tile(narrow, wide):
    """A warp's slice of a group tile: ``narrow`` / ``wide`` bytes of keys
    a d row (32 / 8 as built), in the kernel and in its shared-memory
    layout."""
    return [("(QPL == 1 ? 32 : 8) / elt < 4 ? 4 : (QPL == 1 ? 32 : 8) / elt;",
             f"(QPL == 1 ? {narrow} : {wide}) / elt < 4 ? 4 : (QPL == 1 ? {narrow} : {wide}) / elt;"),
            ("    Tw = (qpl == 1 ? 32 : 8) / elt;", f"    Tw = (qpl == 1 ? {narrow} : {wide}) / elt;")]


VARIANTS = {
    "full": [],
    "narrow_t16": _tile(16, 8),
    "narrow_t64": _tile(64, 8),
    "wide_t16": _tile(32, 16),
    "wide_t4": _tile(32, 4),
    "no_vflat": [("  a.vflat = a.vvec && v_ss == dv;", "  a.vflat = 0;")],
    "guarded_values": [("    if (full)  // every lane owns QPL quads", "    if (false)  // every lane owns QPL quads")],
    "no_swizzle": [("  const int swz_mask = KCg >= 2 ? KCg - 2 : 0;", "  const int swz_mask = 0;")],
    "always_rescale": [("    if (alpha < 1.f) {  // warp-uniform: the max moved", "    if (true) {")],
    "int8_cvt_cheap": [("""__device__ __forceinline__ float4 quad(const int8_t* p) {
  return i8x4_f32(*reinterpret_cast<const uint32_t*>(p));
}""", """__device__ __forceinline__ float4 quad(const int8_t* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float4(__uint_as_float(w), __uint_as_float(w ^ 1u), __uint_as_float(w ^ 2u),
                     __uint_as_float(w ^ 3u));
}""")],
    "no_loads": [("  auto load = [&](int slot, int tile) {\n",
                  "  auto load = [&](int slot, int tile) {\n    if (slot >= 0) return;\n")],
    "no_scores": [NO_SCORES],
    "no_values": [NO_VALUES],
    "no_math": [NO_SCORES, NO_VALUES],
}


def variant_source(name, subs, sources=SOURCES):
    """{file name: text} of a variant: each substitution replaced wherever
    it occurs in the sources (the header's K1 and K8 paths alike); raises
    if one occurs nowhere (so that no build starts)."""
    texts = {p.name: p.read_text() for p in sources}
    for old, new in subs:
        if not any(old in t for t in texts.values()):
            raise AssertionError(f"{name}: substitution not found: {old[:60]!r}")
        texts = {f: t.replace(old, new) for f, t in texts.items()}
    return texts


def build(name, texts, out_dir=OUT_DIR):
    """Compile a variant's entry file (the first of ``texts``) from its own
    directory, whose copy of the header the quoted include finds first."""
    d = out_dir / name
    d.mkdir(parents=True, exist_ok=True)
    for f, text in texts.items():
        (d / f).write_text(text)
    lib = d / f"lib{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
           str(d / next(iter(texts)))]
    return name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)


def ptxas_summary(log, kernel="decode_attention_kernel"):
    """Registers and spill bytes of each kernel instance."""
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            info = [x.strip() for x in lines[i + 1:i + 5] if "spill" in x or "Used" in x]
            out.append(f"{line.split(kernel)[-1][:40]}: {' '.join(info)}")
    return out


def shapes(gen):
    """(label, entry, args, bytes) of the probed calls."""
    bf, dev = torch.bfloat16, cs.DEV
    out = []
    for label, e, dv, s, ragged in (("gpt int8 S512 full", 1536, 64, 512, False),
                                    ("combine int8 S512 ragged", 2048, 768, 512, True)):
        q = (torch.randn(e, 64, generator=gen, device=dev) * 0.125).to(bf)
        kt = torch.randint(-127, 128, (e, 64, s), generator=gen, device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, (e, s, dv), generator=gen, device=dev, dtype=torch.int8)
        ks, vs = torch.rand(2, e, s, generator=gen, device=dev) * 0.05
        lens = (torch.randint(1, s + 1, (e,), generator=gen, device=dev, dtype=torch.int32)
                if ragged else torch.full((e,), s, dtype=torch.int32, device=dev))
        n = int(lens.sum().item())
        out.append((label, da.decode_attention, (q, kt, ks, v, vs, lens),
                    q.numel() * 2 + n * (64 + dv + 8) + e * dv * 2 + e * 4))
    # the INT8 serve's combine at its own lengths: every row at 64 under the
    # 128 window, at 224 under the 256 window of a 512-column cache
    q = (torch.randn(2048, 64, generator=gen, device=dev) * 0.125).to(bf)
    kt = torch.randint(-127, 128, (2048, 64, 512), generator=gen, device=dev, dtype=torch.int8)
    v = torch.randint(-127, 128, (2048, 512, 768), generator=gen, device=dev, dtype=torch.int8)
    ks, vs = torch.rand(2, 2048, 512, generator=gen, device=dev) * 0.05
    for w, n in ((128, 64), (256, 224)):
        lens = torch.full((2048,), n, dtype=torch.int32, device=dev)
        out.append((f"combine int8 W{w} len{n}", da.decode_attention,
                    (q, kt[..., :w], ks[:, :w], v[:, :w], vs[:, :w], lens),
                    q.numel() * 2 + 2048 * n * 840 + 2048 * 1540))
    # K1-ml at the serve-engine's combine: window 256, ragged base lengths
    lens = torch.randint(0, 257, (2048,), generator=gen, device=dev, dtype=torch.int32)
    n = int(lens.sum().item())
    out.append(("combine-ml int8 W256 ragged", da.decode_attention_ml,
                (q, kt[..., :256], ks[:, :256], v[:, :256], vs[:, :256], lens),
                q.numel() * 2 + n * 840 + 2048 * 1548))
    e, s = cs.GEN_ROWS, cs.GEN_WIDTH
    q = (torch.randn(e, 64, generator=gen, device=dev) * 0.125).to(bf)
    kt = torch.randn(e, 64, s, generator=gen, device=dev).to(bf)
    v = torch.randn(e, s, 64, generator=gen, device=dev).to(bf)
    lens = torch.randint(cs.GEN_PROMPT, s + 1, (e,), generator=gen, device=dev, dtype=torch.int32)
    n = int(lens.sum().item())
    out.append(("gpt-generate bf16 S2112", da.decode_attention, (q, kt, None, v, None, lens),
                q.numel() * 2 + n * 256 + e * 64 * 2 + e * 4))
    return out


def schedules(label, args):
    """(name, schedule) overrides of the full kernel at this shape: other
    ring depths, (warps, rows) a CTA, and cluster sizes."""
    q, kt, _, v, _, _ = args
    e, s, dv = q.shape[0], v.shape[1], v.shape[2]
    base = da._k1_schedule(e, 64, dv, s, kt.element_size(), _build.sm_count(0))
    qpl, warps, rows, split, stages = base
    tw = da._k1_warp_tile(qpl, kt.element_size())
    out = [(f"stages={st}", (qpl, warps, rows, split, st)) for st in (2, 3, 4) if st != stages]
    for w, r in ((8, 8), (8, 4), (8, 2), (8, 1), (4, 1), (4, 2), (2, 1)):
        for st in (2, 3):
            if ((w, r, st) != (warps, rows, stages) and (w // r) * tw * kt.element_size() % 16 == 0
                    and r * da._k1_group_bytes(qpl, 64, dv, kt.element_size(), w // r, st) <= 232448):
                out.append((f"w{w}r{r}s{st}", (qpl, w, r, split, st)))
    if split > 1 or label.startswith("gpt-generate"):
        out += [(f"split={c}", (qpl, warps, rows, c, stages)) for c in (1, 2, 4, 8) if c != split]
    return base, out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k1: no CUDA device", file=sys.stderr)
        sys.exit(2)
    rows = [{"nvidia_smi": cs.nvidia_smi_line(), "device": torch.cuda.get_device_name(0)}]
    cs.emit(rows[0])
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    _build.build_all(["decode_attention", "decode_attention_ml"])
    libs = {}
    sources = {n: variant_source(n, VARIANTS[n]) for n in args.variants.split(",")}
    for name, lib, proc in [build(n, text) for n, text in sources.items()]:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build:\n{log}")
        libs[name] = lib
        rows.append({"variant": name, "ptxas": ptxas_summary(log)})
        cs.emit(rows[-1])

    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    calls = shapes(gen)
    forms = [_build.KERNELS["decode_attention"], _build.KERNELS["decode_attention_ml"]]
    default_libs, default_schedule = [k.lib for k in forms], da._k1_schedule
    emit = lambda row: (rows.append(row), cs.emit(row))
    try:
        with torch.inference_mode():
            for name, path in libs.items():
                lib = ctypes.CDLL(str(path))
                lib.kernel_error_string.argtypes = [ctypes.c_int]
                lib.kernel_error_string.restype = ctypes.c_char_p
                for k in forms:     # K1 and its (m, l) form share the source
                    k.lib = lib
                for label, fn, a, nbytes in calls:
                    base, others = schedules(label, a)
                    for sname, sched in [("default", base)] + (others if name == "full" else []):
                        da._k1_schedule = lambda *_, s=sched: s
                        call = lambda a=a, fn=fn: fn(*a)
                        ms, launches = cs.device_ms(call)
                        emit({"variant": name, "shape": label, "schedule": sname,
                              "launch_shape": list(sched), "device_ms": ms,
                              "device_ms_clean": cs.device_ms(call, clean=True)[0],
                              "recorded_launches": launches,
                              "bound_ms": nbytes / cs.PEAK_BYTES_PER_S * 1e3})
                    da._k1_schedule = default_schedule
    finally:
        for k, lib in zip(forms, default_libs):
            k.lib = lib
        da._k1_schedule = default_schedule
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
