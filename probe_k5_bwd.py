"""Locate K5's time on the card: build variants of
``csrc/flash_attention_bwd.cu`` with one part taken out or changed, and time
each at the training shape and at train-8k's.

    python3 probe_k5_bwd.py [--out FILE]

Variants (text substitutions on the source, each built with the package's
nvcc flags into ``build/probe_k5/`` and swapped in as K5's library):

    full        the kernel as it is
    no_dq       no dQ products and no atomics
    no_atomics  the dQ products made, each atomic replaced by a store that
                never runs (its test keeps the products alive)
    no_main     the prep and convert kernels alone
    stages3     a 3-stage cp.async ring
    occupancy3  three 4-warp CTAs an SM (at most 168 registers a thread)

Each at 64- and 128-key tiles, dropout 0.1 and 0, at 32 x 12 x 512 (q, k, v
strided views of one packed tensor) and 2 x 12 x 8192: CUDA-event ms (the
median of 25, L2 flushed) of ``flash_attention_bwd`` with K3's forward
outputs. A variant's numbers say where the time goes, not that its output
is right (no_dq and no_main leave dq unset). One JSON line a timing, the
card's name and power limit first, and ptxas's registers and spills of each
variant's main kernel. Exits non-zero without a card.
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
from backpacks_flash_attn_tpu_torch.ops import flash_attention as fa

SOURCE = _build.CSRC / "flash_attention_bwd.cu"
OUT_DIR = _build.BUILD_DIR.parent / "probe_k5"
DQ_CALLS = ["""    if (t > 0)  // tile t - 1's dQ, while other warps may already work on tile t
      dq_tile<WARPS>(a, dsT + ((t - 1) & 1) * BK * LD, Ks, q0 - BQ, dq_keys(q0 - BQ), b, h);
""", """  dq_tile<WARPS>(a, dsT + ((n_tiles - 1) & 1) * BK * LD, Ks, q_last, dq_keys(q_last), b, h);
"""]
ATOMIC = """      atomicAdd(reinterpret_cast<float4*>(dst + nf * 8),
                odd ? make_float4(r0, r1, acc[nf][2], acc[nf][3])
                    : make_float4(acc[nf][0], acc[nf][1], r0, r1));"""
VARIANTS = {
    "full": [],
    "no_dq": [(call, "") for call in DQ_CALLS],
    "no_atomics": [(ATOMIC, "      if (r0 + r1 + acc[nf][0] + acc[nf][3] == 1234.5f) dst[nf * 8] = r1;")],
    "no_main": [("    cudaError_t err = key_tile == 128 ? launch_mma<8>(a, b, st) : "
                 "launch_mma<4>(a, b, st);", "    cudaError_t err = cudaSuccess;")],
    "stages3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "occupancy3": [("__launch_bounds__(32 * WARPS, 8 / WARPS)", "__launch_bounds__(32 * WARPS, 12 / WARPS)")],
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
    """Registers and spill bytes of each bwd_mma_kernel instance."""
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "bwd_mma_kernel" in line:
            inst = line.split("bwd_mma_kernel")[1].split("E")[0]
            tail = " ".join(lines[i + 1:i + 3])
            out.append(f"{inst}: {tail.strip()}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k5_bwd: no CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = [{"nvidia_smi": cs.nvidia_smi_line(), "device": torch.cuda.get_device_name(0)}]
    cs.emit(rows[0])
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    _build.build_all(["flash_attention", "flash_attention_bwd"])
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
    qkv = torch.randn(32, 512, 3, 12, 64, generator=gen, device=cs.DEV).to(bf)
    shapes["32x12x512"] = (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           torch.randn(32, 512, 12, 64, generator=gen, device=cs.DEV).to(bf))
    shapes["2x12x8192"] = tuple(torch.randn(2, 8192, 12, 64, generator=gen,
                                            device=cs.DEV).to(bf) for _ in range(4))
    k5 = _build.KERNELS["flash_attention_bwd"]
    default_lib, default_tile = k5.lib, fa._k5_key_tile
    try:
        for name, path in libs.items():
            k5.lib = ctypes.CDLL(str(path))
            k5.lib.kernel_error_string.argtypes = [ctypes.c_int]
            k5.lib.kernel_error_string.restype = ctypes.c_char_p
            for tile in (64, 128):
                fa._k5_key_tile = lambda *a, tile=tile: tile
                for p in (0.1, 0.0):
                    for shape, (q, k, v, dout) in shapes.items():
                        kw = dict(causal=True, softmax_scale=0.125, dropout_p=p, seed=(5, 7))
                        out, lse = fa._flash_fwd_kernel(q, k, v, scale=0.125, seq_lengths=None,
                                                        q_offsets=None, causal=True,
                                                        dropout_p=p, seed=(5, 7))
                        ms = cs.time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                                                        **kw))
                        rows.append({"variant": name, "key_tile": tile, "dropout_p": p,
                                     "shape": shape, "ms": ms})
                        cs.emit(rows[-1])
    finally:
        k5.lib, fa._k5_key_tile = default_lib, default_tile
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
