"""Locate the block-sparse op's time on the card, around K9's kernels.

    python3 probe_k9.py [--out FILE]

At chip_smoke's longctx shapes (s 2048 / 4096 / 8192, b = 16384 / s, h 12,
d 64, bf16, the band mask of 256 x 256 blocks), for
``flash_blocksparse_attention`` forward + backward and for the dense
``flash_attention`` beside it:

- event ms (median of 25, L2 flushed before each call, as chip_smoke's
  ``time_ms``) and host microseconds a call (``chip_smoke.host_us``: calls
  back to back, no synchronisation between them);
- one profiled call: every CUDA kernel with its count and device ms, their
  sum and the call's wall ms (so the device's idle share);
- the parts of the op, each alone: the q scaling; the forward's C entry
  (its table build included, as the op calls it); the backward's C entry;
  and the plain version of the tables
  (``_bs_tables``, tensor ops), in host microseconds, event ms and the
  CUDA kernels they launch.

One JSON line each, the card's name and power limit first. Exits non-zero
without a card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs
from backpacks_flash_attn_tpu_torch.ops import flash_attention as fa


def profile_call(fn):
    """fn() once under torch.profiler (after a warm-up): its wall ms and
    its CUDA kernels (name, count, device ms), largest first."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((ev.self_device_time_total / 1e3, ev.key[:90], ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    return dict(wall_ms=wall, device_ms=sum(r[0] for r in rows),
                kernels=sum(r[2] for r in rows),
                top=[dict(ms=ms, name=n, count=c) for ms, n, c in rows[:12]])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k9: no CUDA device", file=sys.stderr)
        sys.exit(2)
    lines = []
    emit = lambda row: (lines.append(row), cs.emit(row))
    emit({"nvidia_smi": cs.nvidia_smi_line(), "device": torch.cuda.get_device_name(0)})
    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    bf = torch.bfloat16
    kw = dict(causal=True, block_q=cs.BS_BLOCK, block_k=cs.BS_BLOCK)
    for s in cs.LONGCTX_SEQLENS:
        b = cs.LONGCTX_TOKENS // s
        q, k, v, g = (torch.randn(b, s, cs.LONG_H, cs.LONG_D, generator=gen,
                                  device=cs.DEV).to(bf) for _ in range(4))
        ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
        bm, _ = cs.band_blockmask(s)
        act = fa.blocksparse_active(bm, True, cs.BS_BLOCK, cs.BS_BLOCK)
        qs = q * cs.LONG_D ** -0.5
        out, lse, tables = fa._bs_fwd_kernel(qs, k, v, bm, **kw)
        ops = {
            "blocksparse_fwd_bwd": lambda: torch.autograd.grad(
                fa.flash_blocksparse_attention(ql, kl, vl, bm, **kw), (ql, kl, vl), g),
            "flash_fwd_bwd": lambda: torch.autograd.grad(
                fa.flash_attention(ql, kl, vl, causal=True), (ql, kl, vl), g),
        }
        parts = {
            "q_scale": lambda: q * cs.LONG_D ** -0.5,
            "fwd_entry": lambda: fa._bs_fwd_kernel(qs, k, v, bm, **kw),
            "bwd_entry": lambda: fa._bs_bwd_kernel(qs, k, v, out, lse, g, tables, **kw),
            "plain_tables": lambda: fa._bs_tables(act, s, s, **kw),
        }
        for name, fn in ops.items():
            emit({"s": s, "op": name, "ms": cs.time_ms(fn), "host_us": cs.host_us(fn, 50),
                  "profile": profile_call(fn)})
        with torch.no_grad():
            for name, fn in parts.items():
                emit({"s": s, "part": name, "ms": cs.time_ms(fn),
                      "host_us": cs.host_us(fn, 100),
                      "kernels": profile_call(fn)["kernels"]})
        del q, k, v, g, ql, kl, vl
        torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(lines, indent=1))


if __name__ == "__main__":
    main()
