"""Locate K4's time on the card: build variants of
``csrc/fused_contextualization.cu`` with one part taken out or changed, and
time each kernel of the launch at the forward's and training's shapes.

    python3 probe_k4.py [--out FILE]

Variants (text substitutions on the source, each built with the package's
nvcc flags into ``build/probe_k4/`` and swapped in as K4's library):

    full         the kernels as they are
    no_scores    every P tile zero: no scores, exponentials or masks (the
                 products and loads remain)
    loads_only   no scores and no products: the consumers wait for each
                 stage and release it
    no_loads     no TMA: the producer arrives on each stage's barrier at
                 once (the consumers compute on whatever shared memory holds)
    stages3      a ring of 3 stages
    pv_no_exp    the product kernel's p without its exponential
    pv_exp_poly  half of p's exponentials (odd columns) on the FMA pipe
    lse_no_exp   the LSE pass without its exponentials
    lse_no_mma   the LSE pass without its score products
    lse_no_loads the LSE pass without its key loads
    lse_no_q     the LSE pass without its query loads
    lse_one_tile the LSE pass over each block's first key tile only

Each at 8 x 512 and 32 x 512 (nv 16, dnv 48, d 768, bf16, q and k strided
views), under the wrapper's row tiling and at 64 and 128 rows: device ms a call of each kernel (torch.profiler, L2 flushed). A
variant's numbers say where the time goes, not that its output is right.
One JSON line a timing, the card's name and power limit first, and
ptxas's registers and spills of each variant's kernels. Exits non-zero
without a card.
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

SOURCE = _build.CSRC / "fused_contextualization.cu"
OUT_DIR = _build.BUILD_DIR.parent / "probe_k4"
ZERO_P = ("if (k0 > r0 + 15) {", "if (true) {")
WGMMA = ("""          wgmma_ra192(acc, pa[u][kk], smem_desc(st + (wkey + 16 * kk) * 128, kBox, 1024),
                      !fresh || i + u > 0 || kk > 0);""", "          fence_regs(pa[u]);")
TMA = [("mbar_expect_tx(bar, kt == kt0 ? kBytes + nq * (kBox + 256) : kBytes);", "mbar_arrive(bar);"),
       ("        tma_load_4d(st + j * kBox, map_c, bar, d0 + 64 * j, head, 64 * kt, b);", "        ;"),
       ("      tma_load_4d(st + kK, map_k, bar, 0, head, 64 * kt, b);", ""),
       ("""          tma_load_4d(st + kQ + j * kBox, map_q, bar, 0, head, q, b);
          bulk_load(st + kL + j * 256, a.ws + (static_cast<long long>(b) * a.NV + head) * a.s_pad + q,
                    256, bar);""", "          (void)q;")]
# 2^x on the FMA pipe (x <= 0): 2^floor(x) times a cubic in the fraction,
# relative error ~1e-4, well under bf16's rounding of p
EXP2_POLY = """__device__ __forceinline__ float exp2_poly(float x) {
  x = fmaxf(x, -127.f);
  const float xi = floorf(x), f = x - xi;
  const float p = fmaf(fmaf(fmaf(0.0790209f, f, 0.2243839f), f, 0.6964869f), f, 1.f);
  return __int_as_float(__float_as_int(p) + (static_cast<int>(xi) << 23));
}

// columns (col, col + 1) of row `row` of out, rounded once"""
VARIANTS = {
    "full": [],
    "no_scores": [ZERO_P],
    "loads_only": [ZERO_P, WGMMA],
    "no_loads": TMA,
    "stages3": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    "pv_no_exp": [("              p[e] = ex2(c[nf][e] * a.scale_log2 - lse2[e >> 1]);",
                   "              p[e] = c[nf][e] * a.scale_log2 - lse2[e >> 1];")],
    "pv_exp_poly": [("              p[e] = ex2(c[nf][e] * a.scale_log2 - lse2[e >> 1]);",
                     "              p[e] = (e & 1) ? exp2_poly(c[nf][e] * a.scale_log2 - lse2[e >> 1])\n"
                     "                             : ex2(c[nf][e] * a.scale_log2 - lse2[e >> 1]);"),
                    ("// columns (col, col + 1) of row `row` of out, rounded once", EXP2_POLY)],
    "lse_no_exp": [("            sum += v == FLASH_NEG_INF ? 0.f : ex2(v - m_new);",
                    "            sum += v == FLASH_NEG_INF ? 0.f : v - m_new;"),
                   ("sum += ex2(c[nf][2 * h + e] - m_new);", "sum += c[nf][2 * h + e] - m_new;")],
    "lse_no_mma": [("        mma_16816(c[nf], qa[ks], bfr);",
                    "        c[nf][0] += __uint_as_float((bfr[0] ^ bfr[1] ^ qa[ks][0]) & 0x3fffffffu);")],
    "lse_no_loads": [("        cp_async16(dst, kb + (j * LK + rr) * k_st + cc * 8);", "        ;")],
    "lse_no_q": [("  load_q_frags(qa, q + b * q_sb + head * q_sh, q_st, r0, S, DNV, g, t);",
                  "  for (int i = 0; i < DNVP / 16; ++i)\n"
                  "    for (int e = 0; e < 4; ++e) qa[i][e] = 0x3c003c00u ^ (tid << 3);")],
    "lse_one_tile": [("  const int n_kt = q0 < S ? (min(S, q0 + LQ) + LK - 1) / LK : 0;",
                      "  const int n_kt = q0 < S ? 1 : 0;")],
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
    """Registers and spill bytes of each kernel instance."""
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "ctx_" in line:
            inst = line.split("ctx_")[1].split("EEv")[0].split("EP")[0]
            tail = " ".join(lines[i + 1:i + 3])
            out.append(f"{inst}: {tail.strip()}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k4: no CUDA device", file=sys.stderr)
        sys.exit(2)
    rows = [{"nvidia_smi": cs.nvidia_smi_line(), "device": torch.cuda.get_device_name(0)}]
    cs.emit(rows[0])
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    _build.build_all(["fused_contextualization"])
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
    for b in (8, 32):
        qk = torch.randn(b, 512, 2, 16, 48, generator=gen, device=cs.DEV).to(bf)
        shapes[f"{b}x512"] = (qk[:, :, 0], qk[:, :, 1],
                              torch.randn(b, 512, 16, 768, generator=gen, device=cs.DEV).to(bf))
    k4 = _build.KERNELS["fused_contextualization"]
    default_lib, default_rows = k4.lib, bk._k4_rows
    try:
        for name, path in libs.items():
            k4.lib = ctypes.CDLL(str(path))
            k4.lib.kernel_error_string.argtypes = [ctypes.c_int]
            k4.lib.kernel_error_string.restype = ctypes.c_char_p
            for forced in (None, 64, 128):
                bk._k4_rows = default_rows if forced is None else (lambda *a, r=forced: r)
                for shape, (q, k, c) in shapes.items():
                    split = kernel_split(lambda: bk._fwd_kernel(q, k, c, 48 ** -0.5))
                    rows.append({"variant": name, "rows": forced, "shape": shape,
                                 "kernels_device_ms": split})
                    cs.emit(rows[-1])
    finally:
        k4.lib, bk._k4_rows = default_lib, default_rows
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
