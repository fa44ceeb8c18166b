"""Compare what nvcc makes of the port's kernel sources in two or more
checkouts: for each kernel, ptxas's registers and spills, and the SASS
instruction count and opcode histogram.

    python3 compare_sass.py --tree DIR --tree DIR [--source flash_attention.cu ...]
                            [--match NAME] [--out FILE]

Each ``--tree`` is the root of a checkout (unpack the other commit with
``git archive`` into a directory that ``.gitignore`` lists). Every source
(a file of ``backpacks_flash_attn_tpu_torch/csrc``; default
``flash_attention.cu``) is compiled in every tree, all at once, with the
flags of ``ops/_build.py`` to a cubin, and disassembled with cuobjdump.
Kernels are paired across the trees in the order of the cubin; their names
(demangled, ``--match`` filters them) may differ by template arguments. One
line a kernel and tree: registers, instructions, spills, name; then whether
the opcode histograms of each pair are equal. Needs the CUDA toolkit
(``nvcc``, ``cuobjdump``, ``cu++filt``), not a card.
"""

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin",
         "-Xptxas", "-v"]   # ops/_build.py's NVCC_FLAGS, to a cubin


def _tool(name: str) -> str:
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name)


def kernels(ptxas_log: str, sass: str, match: str):
    """[(demangled name, registers, spill line, instruction count, opcode
    histogram)] in the cubin's order, the names containing ``match``."""
    regs = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"Compiling entry function '(\S+)'.*?Used (\d+) registers", ptxas_log, re.S)}
    spills = {m.group(1): m.group(2).strip() for m in re.finditer(
        r"Function properties for (\S+)\n\s+(.*)", ptxas_log)}
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and cur is not None:
            funcs[cur][m.group(1).split(".")[0]] += 1
    out = []
    for name, ops in funcs.items():
        pretty = subprocess.run([_tool("cu++filt"), name], capture_output=True,
                                text=True).stdout.strip() or name
        if match in pretty:
            out.append((pretty, regs.get(name), spills.get(name), sum(ops.values()), dict(ops)))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, action="append", required=True)
    ap.add_argument("--source", action="append", default=None)
    ap.add_argument("--match", default="")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    sources = args.source or ["flash_attention.cu"]
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for t, tree in enumerate(args.tree):
            csrc = tree.resolve() / "backpacks_flash_attn_tpu_torch" / "csrc"
            for src in sources:
                cubin = Path(tmp) / f"{t}-{src}.cubin"
                jobs[(t, src)] = (cubin, subprocess.Popen(
                    [_tool("nvcc"), *FLAGS, "-I", str(csrc), "-o", str(cubin), str(csrc / src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        found = {}
        for key, (cubin, proc) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                sys.exit(f"compare_sass: {args.tree[key[0]]} {key[1]}:\n{log}")
            sass = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)], capture_output=True,
                                  text=True, check=True).stdout
            found[key] = kernels(log, sass, args.match)
    rows = []
    for src in sources:
        per_tree = [found[(t, src)] for t in range(len(args.tree))]
        for t, ks in enumerate(per_tree):
            for name, regs, spill, n, _ in ks:
                print(f"{src} tree {t}: {regs} registers, {n} instructions, {spill}: {name}")
        for i, group in enumerate(zip(*per_tree)):
            same = all(k[4] == group[0][4] for k in group)
            print(f"{src} kernel {i}: opcode histograms {'equal' if same else 'differ'} "
                  f"across the trees")
            rows.append(dict(source=src, kernels=[dict(name=k[0], registers=k[1], spill=k[2],
                                                       instructions=k[3], ops=k[4])
                                                  for k in group], equal=same))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
