"""Quantization quality gates: ppl deltas against the fp weights.

Port of ``backpacks_flash_attn_tpu/eval/quant_gates.py``. Targets: INT8
(weights and caches) within 0.1 ppl of the fp weights; INT4 weight-only
(sense table included) within 0.5 ppl. ``run_gates`` scores the weight
configurations through the full forward, ``run_cache_gates`` the cache
configurations through the cached forward (the prefill writes the
quantized caches and attends over them, the operands every decode step
reads).

Usage:
    python -m backpacks_flash_attn_tpu_torch.eval.quant_gates \\
        --workdir runs/micro --corpus tokens.npy --model backpack-micro
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch

from ..models import backpack as bp
from ..models import quantized as qz
from ..ops import _build
from .perplexity import evaluate_perplexity

INT8_GATE = 0.1
INT4_GATE = 0.5


def run_gates(params, cfg, val_tokens: np.ndarray, seqlen: int, *,
              batch_size: int = 4, max_batches: Optional[int] = 25,
              int4_group_size: int = 64, device="cuda") -> Dict[str, float]:
    """{bf16_ppl, int8_ppl, int4_ppl, int4_head4_ppl, *_delta, gate_*} for
    a Backpack tree on ``device``. The int4 arm keeps the tied head at
    INT8 (quantize_backpack_params' default); the head4 arm quantizes the
    head too, so the carve-out is measured wherever the gate is cited."""
    def ppl_of(p):
        return evaluate_perplexity(
            lambda pp, x: bp.backpack_forward(pp, cfg, x), val_tokens, seqlen,
            batch_size, max_batches=max_batches, params=p,
            device=device)["ppl"]

    base = ppl_of(params)
    p8 = ppl_of(qz.quantize_backpack_params(params, cfg, bits=8))
    p4 = ppl_of(qz.quantize_backpack_params(params, cfg, bits=4,
                                            group_size=int4_group_size))
    p4h = ppl_of(qz.quantize_backpack_params(params, cfg, bits=4,
                                             group_size=int4_group_size,
                                             head_bits=4))
    return {
        "bf16_ppl": base, "int8_ppl": p8, "int4_ppl": p4,
        "int4_head4_ppl": p4h,
        "int8_delta": p8 - base, "int4_delta": p4 - base,
        "int4_head4_delta": p4h - base,
        "gate_int8": bool(p8 - base <= INT8_GATE),
        "gate_int4": bool(p4 - base <= INT4_GATE),
        "gate_int4_head4": bool(p4h - base <= INT4_GATE),
        "int4_head_bits": 8,   # the shipped default: the head stays INT8
    }


def run_cache_gates(params, cfg, val_tokens: np.ndarray, seqlen: int, *,
                    batch_size: int = 4, max_batches: Optional[int] = 25,
                    device="cuda") -> Dict[str, float]:
    """Cache-precision gates of the decode path: ppl through the cached
    forward with INT8 weights and the int8, int4 (mixed), int4-senses +
    int8-KV and int8-senses + int4-KV caches, against the fp full
    forward."""
    def cache_ppl(p, bits, kv_bits=None):
        def fwd(pp, x):
            cache = bp.init_backpack_cache(cfg, x.shape[0], seqlen,
                                           torch.int8, device=x.device,
                                           bits=bits, kv_bits=kv_bits)
            logits, _ = bp.backpack_forward_with_cache(pp, cfg, x, cache)
            return logits
        return evaluate_perplexity(fwd, val_tokens, seqlen, batch_size,
                                   max_batches=max_batches, params=p,
                                   device=device)["ppl"]

    base = evaluate_perplexity(
        lambda pp, x: bp.backpack_forward(pp, cfg, x), val_tokens, seqlen,
        batch_size, max_batches=max_batches, params=params,
        device=device)["ppl"]
    q8 = qz.quantize_backpack_params(params, cfg, bits=8)
    c8 = cache_ppl(q8, bits=8)
    c4 = cache_ppl(q8, bits=4)
    c4h = cache_ppl(q8, bits=4, kv_bits=8)
    ckv4 = cache_ppl(q8, bits=8, kv_bits=4)
    return {
        "bf16_ppl": base,
        "int8_cache_ppl": c8, "int8_cache_delta": c8 - base,
        "int4_cache_ppl": c4, "int4_cache_delta": c4 - base,
        "int4_senses_int8_kv_ppl": c4h, "int4_senses_int8_kv_delta":
            c4h - base,
        "int8_senses_int4_kv_ppl": ckv4, "int8_senses_int4_kv_delta":
            ckv4 - base,
        "gate_int8_cache": bool(c8 - base <= INT8_GATE),
        "gate_int4_cache": bool(c4 - base <= INT4_GATE),
        "gate_int4_hybrid_cache": bool(c4h - base <= INT4_GATE),
        "gate_int4_kv_cache": bool(ckv4 - base <= INT4_GATE),
    }


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def main(argv=None) -> None:
    from ..data import lm_dataset as lmd
    from ..training import checkpoint as ckpt_lib
    from ..training import train_cli

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir",
                   help="training workdir of the port's CLI (its newest "
                        "checkpoint)")
    p.add_argument("--checkpoint",
                   help="reference Lightning .ckpt / torch state dict: not "
                        "ported yet (ROADMAP Queue 1 item 5b)")
    p.add_argument("--corpus", required=True,
                   help=".npy token stream; gates eval on its tail "
                        "(--val-fraction)")
    p.add_argument("--model", default="backpack-micro")
    p.add_argument("--seqlen", type=int, default=512)
    p.add_argument("--val-fraction", type=float, default=0.01)
    p.add_argument("--max-batches", type=int, default=25)
    p.add_argument("--cache-gates", action="store_true", default=True,
                   help="also gate the int8/int4 CACHE decode path")
    p.add_argument("--no-cache-gates", dest="cache_gates",
                   action="store_false")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    if bool(a.workdir) == bool(a.checkpoint):
        p.error("exactly one of --workdir / --checkpoint")
    if a.checkpoint:
        raise NotImplementedError(
            "--checkpoint needs the reference checkpoint importer "
            "(utils/torch_import.py), not ported yet: ROADMAP Queue 1 item 5b")

    device = _build.resolve_device(a.device)
    rc = train_cli.RunConfig(corpus=a.corpus, workdir=a.workdir,
                             model=a.model, seqlen=a.seqlen, dtype="bfloat16",
                             val_fraction=a.val_fraction, device=a.device)
    cfg, kind, params0 = train_cli.build_model(rc, device)
    if kind != "backpack":
        raise SystemExit("the gates are defined for Backpack models")
    ckpt = ckpt_lib.latest_checkpoint(a.workdir)
    if ckpt is None:
        raise SystemExit(f"no checkpoint in {a.workdir}")
    restored, step, _ = ckpt_lib.restore(ckpt, {"state": {"params": params0}})
    params = _to_device(restored["state"]["params"], device)
    tokens = lmd.load_corpus(a.corpus)
    n_val = max(int(len(tokens) * a.val_fraction), a.seqlen + 1)
    out = run_gates(params, cfg, tokens[-n_val:], a.seqlen,
                    max_batches=a.max_batches, device=device)
    if a.cache_gates:
        out.update(run_cache_gates(params, cfg, tokens[-n_val:], a.seqlen,
                                   max_batches=a.max_batches, device=device))
    out["checkpoint_step"] = step
    print(json.dumps(out))


if __name__ == "__main__":
    main()
