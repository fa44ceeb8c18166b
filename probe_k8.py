"""Locate K8's time on the card: build variants of
``csrc/lowbit_decode_attention.cu`` (and of ``csrc/decode_attention.cuh``,
the kernel body it shares with K1) with one part taken out, and time K8
and K8-ml under other launch shapes, at the shapes the model paths and
``chip_smoke.py`` launch them at.

    python3 probe_k8.py [--variants NAME,...] [--sweep NAME,...] [--out FILE]

Source variants (text substitutions, each built with the package's nvcc
flags into ``build/probe_k8/NAME/`` and swapped in as K8's library):

    full        the kernel as it is
    no_loads    no copy into the ring (the tiles hold whatever is there)
    no_scores   no q . k products (scores 0)
    no_values   no p @ v products
    no_math     neither products: the copies, the ring's waits, the
                softmax bookkeeping and the merge
    nib_cheap   the int4 words reinterpreted instead of decoded (one xor a
                value for the __byte_perm moves), in keys and values
    no_vflat    value tiles copied by the strided walk
    nothing     no copies and no products: launch, bookkeeping and merge
    no_merge    the partials written, the merge and the output left out
    t16, t64, w16
                a warp's packed columns of a group tile: 16 or 64 of a
                narrow row, 16 of a wide one (32 and 8 as built), the
                schedule under the same warp tile
    lb2, lb3    __launch_bounds__ asking 2 or 3 CTAs of 256 threads an SM
                for every instance (as built: 3 for narrow rows, 2 for
                wide ones)
    q_early     q loaded into registers before the ring's first copies

Launch shapes (the variants of ``--sweep``, ``_k8_schedule`` replaced
for the call):
(warps, rows) a CTA of (8, 4), (8, 2), (8, 1), (4, 2), (4, 1), (2, 1) at
2 and 3 stages where they fit; for few rows each other cluster size.

Shapes: chip_smoke's cases (int4 keys at the GPT rows, E 1536, dk = dv =
64, window 256 of 512, ragged; split int8 keys at the Backpack combine, E
2048, dv 768, S 512, ragged; K8-ml at the GPT rows, window 256 of 512,
ragged base lengths), the low-bit serves' own lengths (every row at 64
under the 128 window, at 224 under the 256 window: GPT int4, combine
mixed), the GPT rows at S 512 full, and E 96 at S 16384: device ms a call
(torch.profiler; the L2 flushed by chip_smoke's zeroing, and again by its
clean read flush) beside the byte bound. A variant's numbers say where the
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

SOURCES = (_build.CSRC / "lowbit_decode_attention.cu", _build.CSRC / "decode_attention.cuh")
OUT_DIR = _build.BUILD_DIR.parent / "probe_k8"
NIB_CHEAP = ("""  const uint32_t l = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t h = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
  lo[0] = __uint_as_float(__byte_perm(l, 0x43000000u, 0x7044));
  lo[1] = __uint_as_float(__byte_perm(l, 0x43000000u, 0x7144));
  lo[2] = __uint_as_float(__byte_perm(l, 0x43000000u, 0x7244));
  lo[3] = __uint_as_float(__byte_perm(l, 0x43000000u, 0x7344));
  hi[0] = __uint_as_float(__byte_perm(h, 0x43000000u, 0x7044));
  hi[1] = __uint_as_float(__byte_perm(h, 0x43000000u, 0x7144));
  hi[2] = __uint_as_float(__byte_perm(h, 0x43000000u, 0x7244));
  hi[3] = __uint_as_float(__byte_perm(h, 0x43000000u, 0x7344));""",
             """  lo[0] = __uint_as_float(w);
  lo[1] = __uint_as_float(w ^ 1u);
  lo[2] = __uint_as_float(w ^ 2u);
  lo[3] = __uint_as_float(w ^ 3u);
  hi[0] = __uint_as_float(w ^ 4u);
  hi[1] = __uint_as_float(w ^ 5u);
  hi[2] = __uint_as_float(w ^ 6u);
  hi[3] = __uint_as_float(w ^ 7u);""")
Q_EARLY = ("""  for (int k = 0; k < a.stages - 1; ++k) {
    if (k < count) load(k, first + k);
    cp_async_commit();
  }
  if (count > 0)
    for (int d = gt; d < a.dk; d += gthreads) qs[d] = to_f32(qr[d]);
""", """  float qreg[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int d = gt + u * gthreads;
    qreg[u] = active && d < a.dk ? to_f32(qr[d]) : 0.f;
  }
  for (int k = 0; k < a.stages - 1; ++k) {
    if (k < count) load(k, first + k);
    cp_async_commit();
  }
#pragma unroll
  for (int u = 0; u < 8; ++u)
    if (gt + u * gthreads < a.dk) qs[gt + u * gthreads] = qreg[u];
""")
# a warp's packed columns of a group tile, narrow and wide rows, as built
# (32, 8)
TILES = {"t16": (16, 8), "t64": (64, 8), "w16": (32, 16)}


def _bounds(narrow, wide):
    return [("__launch_bounds__(kMaxWarps * 32, QPL == 1 ? 3 : 2)",
             f"__launch_bounds__(kMaxWarps * 32, QPL == 1 ? {narrow} : {wide})")]


VARIANTS = {
    "full": [],
    **{name: probe_k1._tile(*t) for name, t in TILES.items()},
    "lb2": _bounds(2, 2),
    "lb3": _bounds(3, 3),
    "q_early": [Q_EARLY],
    "no_merge": [("  if (active) {\n    const float* p0 = reinterpret_cast<const float*>(base);",
                  "  if (false) {\n    const float* p0 = reinterpret_cast<const float*>(base);")],
    "nothing": [("  auto load = [&](int slot, int tile) {\n",
                 "  auto load = [&](int slot, int tile) {\n    if (slot >= 0) return;\n"),
                probe_k1.NO_SCORES, probe_k1.NO_VALUES],
    "no_loads": [("  auto load = [&](int slot, int tile) {\n",
                  "  auto load = [&](int slot, int tile) {\n    if (slot >= 0) return;\n")],
    "no_scores": [probe_k1.NO_SCORES],
    "no_values": [probe_k1.NO_VALUES],
    "no_math": [probe_k1.NO_SCORES, probe_k1.NO_VALUES],
    "nib_cheap": [NIB_CHEAP],
    "no_vflat": [("  a.vflat = a.vvec && v_ss == dv;", "  a.vflat = 0;")],
}
FORMS = ("lowbit_decode_int4", "lowbit_decode_mixed", "lowbit_decode_int4_ml")


def _operands(gen, e, dv, s2, mixed, window=None, lens=None, lo=1):
    """q, keys, ks2, v4, vs2 (window slices of ``window`` // 2 columns of an
    s2-column cache) and lengths (ragged in [lo, window] unless given)."""
    bf, dev = torch.bfloat16, cs.DEV
    w2 = (window or 2 * s2) // 2
    q = (torch.randn(e, 64, generator=gen, device=dev) * 0.125).to(bf)
    kshape = (e, 64, 2, s2) if mixed else (e, 64, s2)
    keys = torch.randint(-128, 128, kshape, generator=gen, device=dev, dtype=torch.int8)
    v = torch.randint(-128, 128, (e, s2, dv), generator=gen, device=dev, dtype=torch.int8)
    ks, vs = torch.rand(2, e, 2, s2, generator=gen, device=dev) * 0.05
    if lens is None:
        lens = torch.randint(lo, 2 * w2 + 1, (e,), generator=gen, device=dev, dtype=torch.int32)
    elif isinstance(lens, int):
        lens = torch.full((e,), lens, dtype=torch.int32, device=dev)
    return (q, keys[..., :w2], ks[..., :w2], v[:, :w2], vs[..., :w2], lens)


def _bytes(args, mixed, ml=False):
    q, keys, _, v, _, lens = args
    e, dv = q.shape[0], v.shape[2]
    valid = lens.clamp(0, 2 * v.shape[1])
    cols = int(((valid + 1) // 2).sum().item())
    return q.numel() * 2 + cols * (64 * (2 if mixed else 1) + dv + 16) + e * dv * 2 + e * (12 if ml else 4)


def shapes(gen):
    """(label, entry, args, split keys, bytes) of the probed calls."""
    out = []
    for label, fn, mixed, ml, kw in (
            ("gpt int4 W256 ragged", da.decode_attention_int4, False, False,
             dict(e=1536, dv=64, s2=256, window=256)),
            ("combine mixed S512 ragged", da.decode_attention_mixed, True, False,
             dict(e=2048, dv=768, s2=256)),
            ("gpt int4-ml W256 ragged", da.decode_attention_int4_ml, False, True,
             dict(e=1536, dv=64, s2=256, window=256, lo=0)),
            ("gpt int4 W128 len64", da.decode_attention_int4, False, False,
             dict(e=1536, dv=64, s2=256, window=128, lens=64)),
            ("gpt int4 W256 len224", da.decode_attention_int4, False, False,
             dict(e=1536, dv=64, s2=256, window=256, lens=224)),
            ("combine mixed W128 len64", da.decode_attention_mixed, True, False,
             dict(e=2048, dv=768, s2=256, window=128, lens=64)),
            ("combine mixed W256 len224", da.decode_attention_mixed, True, False,
             dict(e=2048, dv=768, s2=256, window=256, lens=224)),
            ("gpt int4 S512 full", da.decode_attention_int4, False, False,
             dict(e=1536, dv=64, s2=256, lens=512)),
            ("long int4 E96 S16384", da.decode_attention_int4, False, False,
             dict(e=96, dv=64, s2=8192, lo=8192))):
        args = _operands(gen, mixed=mixed, **kw)
        out.append((label, fn, args, mixed, _bytes(args, mixed, ml)))
    return out


def schedules(args, mixed):
    """(name, schedule) overrides of the kernel at this shape (under the
    variant's warp tile, patched into da._k1_warp_tile)."""
    q, keys, _, v, _, _ = args
    e, s2, dv = q.shape[0], v.shape[1], v.shape[2]
    base = da._k8_schedule(e, 64, dv, s2, mixed, _build.sm_count(0))
    qpl, warps, rows, split, stages = base
    kr = 2 if mixed else 1
    out = []
    for w, r in ((8, 4), (8, 2), (8, 1), (4, 2), (4, 1), (2, 1)):
        tg = (w // r) * da._k1_warp_tile(qpl, 1)
        if tg % 16:
            continue
        for st in (2, 3):
            if ((w, r, st) != (warps, rows, stages)
                    and r * da._k1_group_bytes(qpl, 64, dv, 1, w // r, st, kr, 2) <= 232448):
                out.append((f"w{w}r{r}s{st}", (qpl, w, r, split, st)))
    if split > 1 or e < 2 * _build.sm_count(0):
        tiles = -(-s2 // ((warps // rows) * da._k1_warp_tile(qpl, 1)))
        out += [(f"split={c}", (qpl, warps, rows, c, stages)) for c in (1, 2, 4, 8)
                if c != split and 2 * c <= tiles]
    return base, out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--sweep", default="full",
                    help="variants timed under every launch shape as well")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k8: no CUDA device", file=sys.stderr)
        sys.exit(2)
    rows = [{"nvidia_smi": cs.nvidia_smi_line(), "device": torch.cuda.get_device_name(0)}]
    cs.emit(rows[0])
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    _build.build_all(list(FORMS))
    sources = {n: probe_k1.variant_source(n, VARIANTS[n], SOURCES)
               for n in args.variants.split(",")}
    libs = {}
    for name, lib, proc in [probe_k1.build(n, texts, OUT_DIR) for n, texts in sources.items()]:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build:\n{log}")
        libs[name] = lib
        rows.append({"variant": name,
                     "ptxas": probe_k1.ptxas_summary(log, "lowbit_decode_attn_kernel")})
        cs.emit(rows[-1])

    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    calls = shapes(gen)
    forms = [_build.KERNELS[n] for n in FORMS]
    default_libs, default_schedule = [k.lib for k in forms], da._k8_schedule
    default_tile = da._k1_warp_tile
    emit = lambda row: (rows.append(row), cs.emit(row))
    try:
        with torch.inference_mode():
            for name, path in libs.items():
                lib = ctypes.CDLL(str(path))
                lib.kernel_error_string.argtypes = [ctypes.c_int]
                lib.kernel_error_string.restype = ctypes.c_char_p
                for k in forms:     # K8's forms share the source
                    k.lib = lib
                narrow, wide = TILES.get(name, (32, 8))
                da._k1_warp_tile = lambda qpl, elt, n=narrow, w=wide: max(
                    4, (n if qpl == 1 else w) // elt)
                default_schedule.cache_clear()
                for label, fn, a, mixed, nbytes in calls:
                    base, others = schedules(a, mixed)
                    sweep = others if name in args.sweep.split(",") else []
                    for sname, sched in [("default", base)] + sweep:
                        da._k8_schedule = lambda *_, s=sched: s
                        call = lambda a=a, fn=fn: fn(*a)
                        row = {"variant": name, "shape": label, "schedule": sname,
                               "launch_shape": list(sched)}
                        try:
                            ms, launches = cs.device_ms(call)
                        except RuntimeError as exc:   # a shape the variant refuses
                            emit({**row, "error": str(exc)[:200]})
                            continue
                        row.update(device_ms=ms, recorded_launches=launches,
                                   bound_ms=nbytes / cs.PEAK_BYTES_PER_S * 1e3)
                        if sname == "default":
                            row["device_ms_clean"] = cs.device_ms(call, clean=True)[0]
                        emit(row)
                    da._k8_schedule = default_schedule
    finally:
        for k, lib in zip(forms, default_libs):
            k.lib = lib
        da._k8_schedule, da._k1_warp_tile = default_schedule, default_tile
        default_schedule.cache_clear()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
