"""Locate K6's time on the card: build variants of
``csrc/fused_contextualization_bwd.cu`` with one part taken out or changed,
and time each kernel of the launch at the training shape and at
backpack-mini's widths.

    python3 probe_k6.py [--out FILE]

Variants (text substitutions on the source, each built with the package's
nvcc flags into ``build/probe_k6/`` and swapped in as K6's library):

    full         the kernels as they are
    dp_no_loads  the delta and main passes without their streamed tiles: the
                 producer arrives on each ring stage at once (the resident
                 tile and the side ring still load)
    dp_no_mma    the delta and main passes without their d-wide products
    dp_stages6   a ring of at most 6 stages in the delta and main passes
                 (at most 12 as built; 8 fit beside a resident d of 768)
    delta_by_head  the delta pass's CTAs in (batch, head)-major order inside
                 each query tile (the heads of a wave then read different
                 content tiles)
    main_no_dq   the main pass without dq (no dS k product, no atomics)
    main_no_dk   the main pass without its dk product
    dc_no_loads  the dcontent pass without its dO slabs
    dc_no_mma    the dcontent pass without its alpha^T dO products
    dc_no_store  the dcontent pass without its TMA stores of dcontent

and the full kernels once more with each dcontent CTA on one sense head
(``_k6_heads`` forced to 1: "full heads=1").

Each at 32 x 512 (nv 16, dnv 48, d 768) and 8 x 512 (nv 16, dnv 40, d
640), bf16, q and k strided views: device ms a call of each kernel
(torch.profiler, L2 flushed). A variant's numbers say where the time goes,
not that its output is right. One JSON line a timing, the card's name and
power limit first, and ptxas's registers and spills of each variant's
kernels. Exits non-zero without a card.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from bench_fused_ctx import kernel_split
from backpacks_flash_attn_tpu_torch.ops import _build
from backpacks_flash_attn_tpu_torch.ops import backpack_kernels as bk

SOURCE = _build.CSRC / "fused_contextualization_bwd.cu"
OUT_DIR = _build.BUILD_DIR.parent / "probe_k6"
DP_LOADS = ("""            mbar_expect_tx(bar, L.stage);
            tma_load_4d(st, &map_y, bar, 64 * c, yh, 64 * (u0 + ui0 + w), b);
            if (a.stream_x) tma_load_4d(st + kBox, &map_x, bar, 64 * c, xh, row0, b);""",
            "            mbar_arrive(bar);")
DP_MMA = ("""        wgmma_ss64(acc, smem_desc(xa + 32 * kk, 16, 1024), smem_desc(st + 32 * kk, 16, 1024),
                   c > 0 || kk > 0);""", "        fence_acc(acc);")
DC_LOADS = [("""    for (int j = 0; j < kSlab / 64; ++j)
      tma_load_4d(st + j * kBox, map_g, bar, d0 + 64 * j, 0, 64 * u, b);""",
             "    for (int j = 0; j < 0; ++j) {}"),
            ("mbar_expect_tx(bar, kDcBytes + (u == u0 ? nk * kBox : 0));",
             "mbar_expect_tx(bar, kDcBytes - kDcQ + (u == u0 ? nk * kBox : 0));")]
DC_MMA = ("""          wgmma_ra192(acc, pa[v][kk], smem_desc(st + (wq + 16 * kk) * 128, kBox, 1024),
                      !fresh || i + v > 0 || kk > 0);""", "          fence_regs(pa[v]);")
VARIANTS = {
    "full": [],
    "dp_no_loads": [DP_LOADS],
    "dp_no_mma": [DP_MMA],
    "dp_stages6": [("constexpr int kMaxStages = 12;", "constexpr int kMaxStages = 6;")],
    "delta_by_head": [("  const int bh = MAIN ? blockIdx.x : blockIdx.x / a.n_tiles, b = bh / a.NV, head = bh % a.NV;",
                       "  const int bh = MAIN ? blockIdx.x : blockIdx.x % (gridDim.x / a.n_tiles),"
                       " b = bh / a.NV, head = bh % a.NV;"),
                      ("  const int place = blockIdx.x % a.n_tiles;",
                       "  const int place = blockIdx.x / (gridDim.x / a.n_tiles);")],
    "main_no_dq": [("      dq_part(a, dsT, base + L.rs, u, warp, b, head, nj_end, lane);\n", "")],
    "main_no_dk": [("      box_mma_ab(dk, dsa, slot, nj_end, lane);  // dk += dS^T q_t\n", "")],
    "dc_no_loads": DC_LOADS,
    "dc_no_mma": [DC_MMA],
    "dc_no_store": [("    if (d0 + 64 * j < D) tma_store_4d(map_dc, stg + j * kBox, d0 + 64 * j, head, 64 * kt, b);",
                     "    (void)map_dc;")],
}


def build(name, subs):
    text = SOURCE.read_text()
    for old, new in subs:
        if old not in text:
            raise AssertionError(f"{name}: substitution not found: {old[:60]!r}")
        text = text.replace(old, new)
    src = OUT_DIR / f"{name}.cu"
    src.write_text(text)
    lib = OUT_DIR / f"lib{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(src)]
    return name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)


def ptxas_summary(log):
    """Registers and spill bytes of each tensor-core kernel instance."""
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "ctx_bwd_" in line:
            inst = line.split("ctx_bwd_")[1].split("EEv")[0].split("E14")[0].split("EPK")[0]
            tail = " ".join(lines[i + 1:i + 3])
            out.append(f"{inst}: {tail.strip()}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k6: no CUDA device", file=sys.stderr)
        sys.exit(2)
    rows = [{"nvidia_smi": cs.nvidia_smi_line(), "device": torch.cuda.get_device_name(0)}]
    cs.emit(rows[0])
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    _build.build_all(["fused_contextualization", "fused_contextualization_bwd"])
    libs = {}
    for name, lib, proc in [build(n, s) for n, s in VARIANTS.items()]:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build:\n{log}")
        libs[name] = lib
        rows.append({"variant": name, "ptxas": ptxas_summary(log)})
        cs.emit(rows[-1])

    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    bf = torch.bfloat16
    shapes = {}
    for label, (b, nv, dnv, d) in (("32x512", (32, 16, 48, 768)), ("mini 8x512", (8, 16, 40, 640))):
        qk = torch.randn(b, 512, 2, nv, dnv, generator=gen, device=cs.DEV).to(bf)
        q, k = qk[:, :, 0], qk[:, :, 1]
        c = torch.randn(b, 512, nv, d, generator=gen, device=cs.DEV).to(bf)
        g = torch.randn(b, 512, d, generator=gen, device=cs.DEV).to(bf)
        _, lse = bk._fwd_kernel(q, k, c, dnv ** -0.5)
        shapes[label] = (q, k, c, lse, g, dnv ** -0.5)
    k6 = _build.KERNELS["fused_contextualization_bwd"]
    default_lib, default_heads = k6.lib, bk._k6_heads
    try:
        for name, path in libs.items():
            k6.lib = ctypes.CDLL(str(path))
            k6.lib.kernel_error_string.argtypes = [ctypes.c_int]
            k6.lib.kernel_error_string.restype = ctypes.c_char_p
            for forced in (None, 1) if name == "full" else (None,):
                bk._k6_heads = default_heads if forced is None else (lambda *a, f=forced: f)
                for shape, args_ in shapes.items():
                    split = kernel_split(lambda: bk._bwd_kernel(*args_))
                    rows.append({"variant": name if forced is None else f"{name} heads={forced}",
                                 "shape": shape, "kernels_device_ms": split})
                    cs.emit(rows[-1])
    finally:
        k6.lib, bk._k6_heads = default_lib, default_heads
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
