"""Drive the PyTorch/CUDA port (backpacks_flash_attn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases device,build,kernels,serve,engine,forward,train,
                                    longctx,train8k,generate,decode_kernels,mini,xl,
                                    intervene]
                          [--out DIR]

Phases, each printing one JSON line:

1. device   the card's name and its nvidia-smi name and power limit.
2. build    compile the hand-written kernels (csrc/*.cu, one nvcc per
            source, all at once) and report the seconds.
3. kernels  each kernel at the main path's shapes against its plain PyTorch
            version: the kernel's max error against an f32 plain reference
            must be at most twice the bf16 plain version's. Times (CUDA
            events, median of 25, L2 flushed before each), the bound, and one
            PyTorch library call computing the same function; K1's
            cases (and K1-ml's) also the profiler's device ms (each kernel
            at its mean time a launch times its recorded launches) and the
            host's microseconds a call. K8 (int4
            and mixed) against its plain version at the GPT decode and
            Backpack combine shapes, library = SDPA over the dequantized
            cache, with device and host times as K1's (every K8 and K8-ml
            case has them); the (m, l) forms of the staged decode, K8-ml at the GPT
            int4 shape and K1-ml at the staged INT8 GPT and Backpack
            combine shapes, each on out, m and l. K2 (the INT8/INT4
            weight-dequant GEMM) at the decode step's shapes (M 128:
            768 -> 2304, 768, 3072, 50264; 3072 -> 768; grouped INT4 g128)
            and the prefill's (M 4096), library torch.matmul on the bf16
            weight, each launch-gated and also timed by the profiler's
            device time and by the host's microseconds a call.
4. serve    backpack-small at full width, random weights from a seeded
            generator, 128 requests with 32-token prompts: batched prefill,
            then 224 greedy tokens (window 128 below position 128, 256
            after), in bf16 (bf16 caches), in INT8 (INT8 weights and
            caches), and with INT8 weights over the low-bit caches: kv4
            (INT8 ctx-K and senses, int4 GPT KV) and int4 (the mixed
            ctx-K/sense cache, int4 GPT KV). Tokens/s, launch counts (reset
            just before, read just after each run; per decode step the
            low-bit runs must launch K8 over the int4 KV once per layer and
            the combine once, K8 over the mixed cache or K1), and the first
            8 teacher-forced steps of the kernel path against the plain
            path in the same cache configuration under the same 2x rule.
            Device time by kernel from torch.profiler over all 224 steps
            (bf16, INT8) or the first 32 (kv4, int4), K2's, K1's and K8's
            device ms a step among it (K1's and K8's recorded launches
            beside).
5. engine   serve-engine: ServingEngine over INT8 weights and INT8 caches
            at its defaults (stage 64, windows 128/256/384/512), 128 slots,
            max_seqlen 512, 256 greedy requests (prompts of 16-64 tokens,
            64-224 new tokens, from the seeded generator), so that slots
            retire and refill: stats(), launches (K1's (m, l) form 13 times
            a decode step, plain K1 never, K2 50 a step and a prefill, K3
            12 a prefill), a profiled 32-step stretch (idle share), and the
            share of requests whose tokens equal the same engine's under
            plain_path() (reported, not gated). serve-staged-kv4: the model
            path over the staged int4-KV cache (INT8 ctx-K and senses):
            128 prompts of 32 tokens prefilled at a scalar length and
            inserted as the engine admits, then 224 greedy steps under
            windows 128/256, flushing whenever 64 staged columns fill; K8-ml
            12 and K1-ml 1 a step. Then the teacher-forced gate of 8 decode
            steps in the staged INT8 and staged kv4 configurations, ragged
            slot lengths, a 4-column stage (a flush inside the steps).
6. forward  backpack_forward at (8, 512) in bf16 through K3 and K4, logits
            against the plain path under the 2x rule.
7. train    backpack-small at full width and depth, bf16 weights from the
            seeded generator, AdamW (warmup 10, lr 6e-4) on a bigram corpus
            over the first 4096 ids. Two runs at batch 32 x 512: (a) the
            einsum combine, 40 steps, (b) fused_ctx=True (K4 forward, K6
            backward), 12 steps. Step ms (median of 10 timed steps after 2
            warm-up steps), tokens/s, an MFU estimate, peak memory, the
            launches of every step (K3 and K5 12 each, K6 at least 1 in
            (b)), the loss of every step, one profiled step; the learning
            gate: the mean loss of the last 5 of (a)'s 40 steps at least 1
            nat below the first 5's. Then a gradient gate on 5 batches of
            8 x 512 at the weights of (a)'s last step, dropout on, both
            combine routes, kernel path vs plain path against an f32 plain
            reference: per batch, the 2x rule of relative error on the
            per-token losses, the whole gradient (every leaf as one vector)
            and the gradients of wte, the first and last GPT layer's Wqkv
            and ctx_attn.Wqkv; pooled over the batches, the signed error of
            the global gradient norm (bias) within 2x the plain path's plus
            3 standard errors, and that of the loss the same way with both
            paths taken net of a shared path (the bf16 model with its
            attention computed in f32 on the bf16 activations), whose bias
            at given weights both paths carry.
            The kernels phase also holds K3 with dropout, K4, K5 and K6 at
            the training shapes (K3's bf16 cases run its tensor-core loop:
            mma.sync over 64-query tiles up to sq 1024, 128 past it, 32 at
            the prefill's sq = 32, K/V through a cp.async ring; f32 and
            unaligned bf16 its SIMT loop), and the long-context kernels: K7 (the
            fused MLP forward) at gpt3-small's training MLP, 16384 tokens,
            768 -> 3072 -> 768, bf16 and f32; K9's forward (out, LSE) at
            b 4, s 4096, h 12 under bench_longctx.py's band mask (band
            1024 + global block 0, 256 x 256 blocks), again with per-row
            key lengths and with a query block that has no active tile,
            and K9's backward (dq, dk, dv: one C entry, one launch count).
8. longctx  bench_longctx.py on the card: at s = 2048, 4096, 8192 (b =
            16384 / s, h 12, d 64, bf16) the causal flash forward (K3) and
            forward + backward (K3 + K5): ms, TFLOP/s, peak memory; the
            block-sparse forward + backward (K9) under the band mask: ms,
            density, peak memory; each with the launches of one call
            (counts reset just before, read just after).
9. train8k  gpt3-small with rotary embeddings (gpt3s-flash-rotary-8k) at
            full width and depth, bf16 weights from the seeded generator,
            AdamW, dropout on, the fused-MLP switch (BACKPACKS_FUSED_MLP)
            on, batch 2 x 8192, no remat: step ms (median of 10 after 2
            warm-up), tokens/s, MFU, peak memory, the losses, K3, K5 and
            K7 12 launches each step, one profiled step; then the gradient
            gate (as in train) on 5 batches of 1 x 2048, at weights that
            every run of one tree reproduces: the seeded weights trained 12
            AdamW steps at 1 x 2048 on the plain path under
            torch.use_deterministic_algorithms (gate_weights).
10. generate generate_gpt on that model: batch 8, a 2048-token prompt, 64
            greedy tokens, bf16 cache: seconds, tokens/s, the prefill apart,
            K3 12 a prefill and K1 12 a decode step, a profile of 8 decode
            steps (K1's device ms a step among it), and the teacher-forced
            gate of the last prompt position and the first 8 decode steps
            under the 2x rule.
11. decode_kernels  bench_int4_kernels.py's comparison, extended: at its
            six shapes (backpack-small's batch-128 decode: GPT KV, E 1536,
            dk = dv = 64, and the Backpack combine, E 2048, dk 64, dv 768;
            S 128/256/512), under full lengths and ragged ones with an
            empty row, one call each of K1, K1-gathered, K1-selector (values
            transposed, and transposed by the wrapper), K1-blockdiag over
            INT8 caches and of K8 over the int4 and mixed caches through
            JAX's direct entries; K1 and gathered at gpt-generate's decode
            shape (E 96, S 2112, bf16: K1 on a cluster of 2 CTAs a row,
            gathered on its length-balanced grid) and at S 16384, with
            device and host times; K1-gathered, K1-selector (both layouts)
            and K1-blockdiag at gpt-generate's rows over S 65,536 (bf16,
            row 0 empty), past the warp-a-row kernels' old cap, from a
            generator of their own. Each call
            against its plain version under the 2x rule, timed beside SDPA
            over the dequantized cache, and launch-gated: the counts reset
            just before it and read just after, its own kernel once and no
            other. Drawn after every other phase, so their data stay put.
            Then (with kernels) K3 at train-8k's sequence, 1 x 8192, h 12,
            causal, dropout 0.1: bound by its flops, SDPA beside; and last
            K7 at gpt3-small's widths over 16384 - 37 tokens (bf16), a
            partial last token tile. Last, K2 at ctx_attn.Wqkv's decode
            shape (768 -> 1536) and at fc1's with a bf16 bias through
            quant_linear (the bias in K2's epilogue, checked bit-equal to K2
            followed by the eager f32 add), both launch-gated; then the "K2
            a decode step" row: the 50 launches' kernel and library event,
            device and host times and bounds summed (12 x the four layer
            shapes, ctx_attn, the lm-head). Last, K5 at train-8k's shape
            (2 x 8192, h 12, causal, dropout 0.1; its plain versions four
            heads at a time), bound by its flops, SDPA's backward beside;
            it and the training-shape K5 case are launch-gated, with
            device and host times. Last of all, K4 at backpack-mini's
            widths (8 x 512, nv 16, dnv 40, d 640: a partial last column
            slab), beside SDPA per head summed; every K4 case (the
            forward's 8 x 512 and training's 32 x 512 too) is
            launch-gated, with device and host times. Then K6 at
            backpack-mini's widths (8 x 512, nv 16, dnv 40, d 640), SDPA's
            backward per head beside; both K6 cases (training's 32 x 512
            too) take K4's LSE, are launch-gated (K6's four launches count
            once) and carry device and host times. Last, K1 at the INT8
            serve's own decode lengths (every row at 64 under the 128
            window, at 224 under the 256 window of a 512 cache; GPT rows
            and the combine), launch-gated, with device and host times.
            Then K8 the same way at the low-bit serves' own lengths (K8
            int4 and K8-ml at the GPT rows, K8 mixed at the combine), and
            K8 int4 past the old kernel's S/2 cap of 4096: E 96, S 16384
            (8192 packed columns), lengths 8192-16384. Last, K9 past the
            old kernels' cap of 512 blocks a row or column (block 64,
            non-causal, a random mask): the forward at sq 128 over sk
            33,280 and the backward at sq 33,280 over sk 128. Last, K3, K5
            and K9 at the head dims past 64 (head_dim_cases): 80 at
            backpack-mini's training shape (32 x 512, 8 heads), 96 and 128
            at gpt3-large's and gpt3-xl's (2 x 2048, 16 heads), each in
            bf16 (tensor cores) and f32 (the SIMT loops; 1 x 512 x 8 at 96
            and 128), K9 under the band mask at 2 x 2048 x 16; the padded
            head dim 112 (2 x 1024 x 8); an unaligned bf16 view at d 80
            (K3's SIMT loop); K3 at the xl generation's prefill (8 x 512 x
            16 x 128); last, K3 and K5 in f32 at d 80 at the training CLI's
            own shape (8 x 512 x 8, the mini phase's SIMT launches). Each
            launch-gated, with device and host times beside SDPA's.
12. mini    backpack-mini (8 layers, 640, 8 heads of 80, 16 senses of 40)
            at full width and depth, bf16 weights from the seeded
            generator: train-einsum (40 steps) and train-fused (12) at 32 x
            512 on the bigram corpus, K3 and K5 8 launches a step (the
            fused route K4 and K6 too), the learning gate, the gradient gate
            (both routes) at gate_weights (8 x 512); the training CLI
            (train_cli.main --model backpack-mini, f32, smoke mode's 3
            steps) on a corpus written under DIR, K5 24 launches and K3 24
            plus the validation forward's; backpack_forward at (8, 512): K3
            8 and K4 1, logits under the 2x rule; serving in bf16 (128
            prompts of 32, 224 greedy tokens): K3 8 a prefill, K1 9 a
            decode step (dk 80 over the GPT layers, the combine), the
            teacher-forced gate, a 32-step profile.
13. xl      gpt3-xl with rotary embeddings (24 layers, 2048, 16 heads of
            128, 64 rotated channels) at full width and depth, bf16 weights
            from the seeded generator: training at 2 x 2048 (AdamW, dropout,
            the fused MLP), K3, K5 and K7 24 launches a step, 12 steps, one
            profiled; the gradient gate at full depth on 5 batches of 1 x
            2048 at gate_weights; generate_gpt at batch 8, prompt 512, 32
            tokens: K3 24 a prefill, K1 24 a decode step, the tokens against
            the plain path's (equal up to each sequence's first
            difference, which must be a near-tie of the plain path's
            logits) and the teacher-forced gate.
14. intervene  the Backpack interventions on backpack-small at full width
            and depth, bf16 weights from the seeded generator (drawn after
            every other phase): a control_weights table (strength 2 over 8
            word ids from the generator) and a toxicity_weights table; the
            teacher-forced gate of weighted_decode_step (annealed) and
            negative_decode_step (quantile 0.02, m 1006) over a prefill of 8
            x 32 and 8 decode steps, in bf16 (bf16 caches) and in INT8 (INT8
            weights and caches): kernel path, plain path and the f32 plain
            reference on the kernel path's greedy tokens, the 2x rule on
            every step's logits, each kernel-path call launch-gated (K3 12 a
            prefill; K1 13 a decode step: the 12 GPT layers and the combine,
            with the sense weights folded into its value scales; K2 50 a
            call over INT8 weights). weighted_forward and
            replaced_word_forward at (8, 512), bf16, through K3 (12) and K4
            (1) against the plain path under the 2x rule. The engine: INT8
            weights and caches at its defaults, 128 slots, 256 greedy
            requests (engine's prompts and budgets), 64 control and 64
            negative, the rest plain: stats(), launches (a step with a
            control or negative slot active runs the flushed plain view:
            plain K1 13 and K1-ml 0; the other steps K1-ml 13; K2 50 a step
            and a prefill; K3 12 a prefill), peak device memory and the
            negative state's bytes, a 32-step profile (idle share, the eager
            ops' share of device time), and the share of each kind of
            request whose tokens equal the same engine's under plain_path()
            (reported, not gated). Between the forwards and the INT8 gate,
            the experiment loops end to end on the bf16 weights:
            run_control_experiment (strengths 0-3, 8 prompts of 32, 32
            tokens), run_toxicity_experiment (sampled from the generator),
            run_genderbias_experiment (4 + 4 prompts of 16, sense 10, 10
            Nelder-Mead iterations) and localize_prediction: seconds and
            finiteness.

Then the {"kernels": [...]} line, the nvidia-smi name/power line, and last
{"ok": true, "device": {...}}. Every number also goes to DIR/chip_smoke.json
and the compiler's register/spill report to DIR/ptxas.txt (DIR defaults to
build/chip_smoke). Any failure raises and exits non-zero; with
no CUDA device it exits non-zero before printing any result. TF32 is off
(torch.backends.cuda.matmul.allow_tf32 = False, cudnn.allow_tf32 = False).
"""

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# cuBLAS's workspace as PyTorch sizes it on an H100, named so that
# torch.use_deterministic_algorithms admits cuBLAS calls (gate_weights)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor core
PEAK_F32_FLOP_PER_S = 67e12    # H100 SXM f32 outside the tensor cores
REPS = 25
DEV = "cuda"


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


_FLUSH = None


def flush_l2():
    """Overwrite a buffer larger than the 50 MB L2 so the next launch
    finds its inputs cold, as the decode loop does."""
    global _FLUSH
    if _FLUSH is None:
        with torch.inference_mode(False):       # usable in and out of it
            _FLUSH = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    _FLUSH.zero_()


_FLUSH_READ = None


def flush_l2_clean():
    """Evict the L2 by reading (summing) a buffer larger than it: the lines
    left are clean, so the next launch writes none of the flush back to
    device memory (flush_l2's zeroing leaves up to the L2's 50 MB dirty for
    the timed kernel to write back). Its kernel is a reduce_kernel."""
    global _FLUSH_READ
    if _FLUSH_READ is None:
        with torch.inference_mode(False):
            _FLUSH_READ = torch.ones(32 << 20, dtype=torch.float32, device="cuda")
    _FLUSH_READ.sum()


def time_ms(fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush_l2()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps=REPS, clean=False):
    """Device time of fn's kernels a call from torch.profiler, the L2
    flushed before each call (the flush's own kernel left out; ``clean``:
    by flush_l2_clean): each kernel at its mean time a launch, times its
    launches a call (its recorded launches over ``reps``, rounded up; the
    profiler has left launches out of its record late in a long run). ->
    (ms, launches recorded a call)."""
    from torch.profiler import ProfilerActivity, profile
    flush, skip = (flush_l2_clean, "reduce_kernel") if clean else (flush_l2, "fill")
    flush()                 # the flush buffer is made outside the record
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            fn()
        torch.cuda.synchronize()
    events = [ev for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA and ev.count
              and skip not in ev.key.lower()]
    us = sum(ev.self_device_time_total / ev.count * -(-ev.count // reps) for ev in events)
    return us / 1e3, sum(ev.count for ev in events) / reps


def host_us(fn, calls=200):
    """Host microseconds a call: calls back to back, no synchronisation
    between them (the launch queue absorbs them)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def bound(nbytes, flops, flop_rate=PEAK_BF16_FLOP_PER_S):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, ref):
    if a.shape != ref.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(ref.shape)}")
    return (a.float() - ref.float()).abs().max().item()


def two_x(name, out, plain, ref):
    """The kernel-vs-baseline rule: err(kernel) <= 2 * err(bf16 plain),
    for each output of a tuple (dq, dk, dv, ...); returns the largest
    errors."""
    if isinstance(out, tuple):
        errs = [two_x(f"{name}[{i}]", o, p, r)
                for i, (o, p, r) in enumerate(zip(out, plain, ref))]
        return max(e for e, _ in errs), max(e for _, e in errs)
    ek, ep = max_err(out, ref), max_err(plain, ref)
    if not (ep > 0 and ek <= 2 * ep):
        raise AssertionError(f"{name}: kernel error {ek:.3e} exceeds 2x the "
                             f"bf16 plain error {ep:.3e}")
    return ek, ep


# ------------------------------------------------------------------ kernels

def k1_cases(gen):
    """K1: GPT rows (E = 128*12, dv = 64) and Backpack rows (E = 128*16,
    dv = 768) over a 512 window, ragged per-row lengths, bf16 and int8;
    CUDA-event, profiler device and host times beside SDPA's."""
    from backpacks_flash_attn_tpu_torch.ops import decode_attention as da

    dev = DEV
    bf = torch.bfloat16
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    cases = []
    for label, E, dv in (("gpt", 128 * 12, 64), ("backpack", 128 * 16, 768)):
        S, dk = 512, 64
        lens = torch.randint(1, S + 1, (E,), generator=gen, device=dev,
                             dtype=torch.int32)
        q = (randn(E, dk) * 0.125).to(bf)
        for cache in ("bf16", "int8"):
            if cache == "int8":
                kt = torch.randint(-127, 128, (E, dk, S), generator=gen,
                                   device=dev, dtype=torch.int8)
                v = torch.randint(-127, 128, (E, S, dv), generator=gen,
                                  device=dev, dtype=torch.int8)
                ks = torch.rand(E, S, generator=gen, device=dev) * 0.05
                vs = torch.rand(E, S, generator=gen, device=dev) * 0.05
            else:
                kt, v, ks, vs = randn(E, dk, S).to(bf), randn(E, S, dv).to(bf), None, None
            args = (q, kt, ks, v, vs, lens)
            ref_args = (q.float(), kt.float(), ks, v.float(), vs, lens)
            kd = kt.float() * (ks[:, None, :] if ks is not None else 1.0)
            vd = v.float() * (vs[..., None] if vs is not None else 1.0)
            lk = kd.transpose(1, 2).to(bf)[None]        # (1, E, S, dk)
            lv = vd.to(bf)[None]
            mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[None, :, None, :]
            n = lens.sum().item()
            kvb = kt.element_size()
            nbytes = (q.numel() * 2 + n * dk * kvb + n * dv * kvb + E * dv * 2
                      + E * 4 + (2 * n * 4 if ks is not None else 0))
            cases.append(("decode_attention", f"{label}-{cache} E={E} S={S} dv={dv}", dict(
                kernel=lambda a=args: da.decode_attention(*a),
                plain=lambda a=args: da.decode_attention_ref(*a),
                ref=lambda a=ref_args: da.decode_attention_ref(*a),
                library=lambda q=q, lk=lk, lv=lv, m=mask: F.scaled_dot_product_attention(
                    q[None, :, None, :], lk, lv, attn_mask=m, scale=1.0)[0, :, 0],
                bytes=nbytes, flops=2 * n * (dk + dv), device_times=True)))
    return cases


def k8_cases(gen):
    """K8 at the kernels phase's shapes (drawn where kernel_cases always drew
    them): int4 keys at the GPT decode shape, split int8 keys at the
    Backpack combine's; with profiler device and host times."""
    from backpacks_flash_attn_tpu_torch.ops import decode_attention as da
    from backpacks_flash_attn_tpu_torch.ops import quant

    dev = DEV
    bf = torch.bfloat16
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    cases = []
    # K8: int4 at the GPT decode shape (E = 128*12, dk = dv = 64; a 512
    # cache read under the 256 window, a strided slice of 128 of its 256
    # packed columns) and mixed at the Backpack shape (E = 128*16, split
    # int8 keys dk 64, dv 768, S 512); random per-row lengths, the first odd
    for kind, label, E, dv, S, W in (("int4", "gpt", 128 * 12, 64, 512, 256),
                                     ("mixed", "backpack", 128 * 16, 768, 512, 512)):
        dk, S2, W2 = 64, S // 2, W // 2
        lens = torch.randint(1, W + 1, (E,), generator=gen, device=dev,
                             dtype=torch.int32)
        lens[0] = W - 1
        q = (randn(E, dk) * 0.125).to(bf)
        kshape = (E, dk, 2, S2) if kind == "mixed" else (E, dk, S2)
        keys = torch.randint(-127, 128, kshape, generator=gen, device=dev,
                             dtype=torch.int8)[..., :W2]
        v = torch.randint(-128, 128, (E, S2, dv), generator=gen, device=dev,
                          dtype=torch.int8)[:, :W2]
        ks = (torch.rand(E, 2, S2, generator=gen, device=dev)
              * (0.05 / 16 if kind == "mixed" else 0.05))[..., :W2]
        vs = (torch.rand(E, 2, S2, generator=gen, device=dev) * 0.05)[..., :W2]
        fn = da.decode_attention_mixed if kind == "mixed" else da.decode_attention_int4
        flat = (da.decode_attention_flat_mixed if kind == "mixed"
                else da.decode_attention_flat_int4)
        args = (q, keys, ks, v, vs, lens)
        ref_args = (q.float(), keys, ks, v, vs, lens)
        # the library yardstick: SDPA over the dequantized, interleaved cache
        if kind == "mixed":
            kq = keys.transpose(2, 3).reshape(E, dk, W)
        else:
            kq = quant.unpack_int4_pairs(keys, 2)
        kd = kq.float() * quant.interleave_pair_scales(ks)[:, None, :]
        vd = quant.unpack_int4_pairs(v, 1).float() * quant.interleave_pair_scales(vs)[..., None]
        lk, lv = kd.transpose(1, 2).to(bf)[None], vd.to(bf)[None]
        mask = (torch.arange(W, device=dev)[None, :] < lens[:, None])[None, :, None, :]
        n = lens.sum().item()
        cols = ((lens + 1) // 2).sum().item()
        kbytes = dk * (2 if kind == "mixed" else 1)
        nbytes = (q.numel() * 2 + cols * (kbytes + dv + 16) + E * dv * 2 + E * 4)
        cases.append((f"lowbit_decode_{kind}", f"{label}-{kind} E={E} S={S} window={W} dv={dv}", dict(
            kernel=lambda a=args, fn=fn: fn(*a),
            plain=lambda a=args, fn=flat: fn(*a),
            ref=lambda a=ref_args, fn=flat: fn(*a),
            library=lambda q=q, lk=lk, lv=lv, m=mask: F.scaled_dot_product_attention(
                q[None, :, None, :], lk, lv, attn_mask=m, scale=1.0)[0, :, 0],
            bytes=nbytes, flops=2 * n * (dk + dv), device_times=True)))
    return cases


def kernel_cases(gen):
    """(kernel name, case label, run dict) for every main-path shape."""
    bf = torch.bfloat16
    randn = lambda *s: torch.randn(*s, generator=gen, device=DEV)
    cases = k1_cases(gen)

    cases += k8_cases(gen)

    # K2: (128 and 4096) x 768 @ 768 x {2304, 768, 3072, 50304} int8, the
    # fc2 3072 x 768, and one grouped INT4 case
    for M in (K2_DECODE_M, K2_PREFILL_M):
        for K, N, bits, gs in K2_SHAPES + ([(768, 3072, 4, 128)] if M == K2_DECODE_M else []):
            cases.append(k2_case(gen, M, K, N, bits, gs))

    cases += k3_cases(gen)

    # K4: (8, 512, 16, 48) with d = 768
    qk = randn(8, 512, 2, 16, 48).to(bf)
    cases.append(k4_case("", qk[:, :, 0], qk[:, :, 1], randn(8, 512, 16, 768).to(bf)))
    return cases + ml_kernel_cases(gen)


def k3_cases(gen):
    """K3: the cached prefill (128, 12, 32 queries over a 512-column cache,
    seq_lengths = offset + 32), the same with per-sequence offsets, and the
    (8, 12, 512) causal forward; the bytes count the key/value columns the
    masks leave readable."""
    from backpacks_flash_attn_tpu_torch.ops import flash_attention as fa

    dev = DEV
    bf = torch.bfloat16
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    cases = []
    for label, b, sq, sk, ragged in (("prefill", 128, 32, 512, False),
                                     ("ragged", 128, 32, 512, True),
                                     ("forward", 8, 512, 512, False)):
        h, d = 12, 64
        q = randn(b, sq, h, d).to(bf)
        k, v = randn(b, sk, h, d).to(bf), randn(b, sk, h, d).to(bf)
        kw = dict(causal=True, softmax_scale=0.125)
        if label != "forward":
            # the serve prefill writes 32 tokens at offset 0 of a 512-column
            # cache; "ragged" adds per-sequence offsets (chunked prefill)
            offs = (torch.randint(0, sk - sq + 1, (b,), generator=gen, device=dev,
                                  dtype=torch.int32) if ragged
                    else torch.zeros(b, dtype=torch.int32, device=dev))
            kw.update(seq_lengths=offs + sq, q_offsets=offs)
            kpos = torch.arange(sk, device=dev)
            qpos = offs[:, None] + torch.arange(sq, device=dev)[None, :]
            mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]   # (b,1,sq,sk)
            lib = lambda q=q, k=k, v=v, m=mask: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=m, scale=0.125).transpose(1, 2)
            pairs = int(mask.sum().item()) * h
            kv_cols = int((offs + sq).sum().item())
        else:
            lib = lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, scale=0.125).transpose(1, 2)
            pairs = b * h * sq * (sq + 1) // 2
            kv_cols = b * sk
        nbytes = 2 * (2 * q.numel() + 2 * kv_cols * h * d) + b * h * sq * 4
        cases.append(("flash_attention", f"{label} b={b} h={h} sq={sq} sk={sk}", dict(
            kernel=lambda a=(q, k, v), kw=kw: fa.flash_attention(*a, **kw),
            plain=lambda a=(q, k, v), kw=kw: fa.flash_attention_ref(*a, **kw),
            ref=lambda a=(q, k, v), kw=kw: fa.flash_attention_ref(
                *(t.float() for t in a), **kw),
            library=lib, bytes=nbytes, flops=4 * pairs * d)))
    return cases


def k4_case(label, q, k, c):
    """K4 against its plain version: q, k (b, s, nv, dnv), c (b, s, nv, d),
    scale dnv^-1/2; launch-gated, with device and host times; library =
    SDPA per sense head (value width d), summed over the heads. Draws no
    random numbers."""
    from backpacks_flash_attn_tpu_torch.ops import backpack_kernels as bk

    b, s, nv, dnv = q.shape
    d = c.shape[-1]
    scale = dnv ** -0.5
    pairs = b * nv * s * (s + 1) // 2
    qT, kT, cT = (t.transpose(1, 2) for t in (q, k, c))
    return ("fused_contextualization", f"{label}b={b} s={s} nv={nv} dnv={dnv} d={d}", dict(
        kernel=lambda: bk.fused_contextualization(q, k, c, scale),
        plain=lambda: bk.contextualization_reference(q, k, c, scale),
        ref=lambda: bk.contextualization_reference(q.float(), k.float(), c.float(), scale),
        library=lambda: F.scaled_dot_product_attention(
            qT, kT, cT, is_causal=True, scale=scale).sum(dim=1),
        # read q, k and content once, write out; the score and value
        # products over the causal pairs
        bytes=2 * (2 * q.numel() + c.numel() + b * s * d),
        flops=2 * pairs * (dnv + d),
        gate="fused_contextualization", device_times=True))


def k4_mini_cases(gen):
    """K4 at backpack-mini's widths (nv 16, dnv 40, d 640: a partial last
    column slab) at the forward's (8, 512)."""
    qk = torch.randn(8, 512, 2, 16, 40, generator=gen, device=DEV).to(torch.bfloat16)
    c = torch.randn(8, 512, 16, 640, generator=gen, device=DEV).to(torch.bfloat16)
    return [k4_case("mini ", qk[:, :, 0], qk[:, :, 1], c)]


def ml_kernel_cases(gen):
    """The (m, l) forms, main segments of the staged serving decode, each
    over a 256 window of a 512 cache (strided slices) with ragged base
    lengths, one row at 0 (an empty main segment): K8-ml at the GPT int4
    shape (E = 128*12, dk = dv = 64), K1-ml at the staged INT8 GPT shape
    and at the Backpack combine (E = 128*16, dk 64, dv 768). Each holds
    out, m and l against its plain version; the library yardstick is SDPA
    over the dequantized window (the empty row attends column 0 there)."""
    from backpacks_flash_attn_tpu_torch.ops import decode_attention as da
    from backpacks_flash_attn_tpu_torch.ops import quant

    dev, bf = DEV, torch.bfloat16
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    S, W, dk = 512, 256, 64
    cases = []

    def sdpa(q, kd, vd, lens):
        mask = torch.arange(W, device=dev)[None, :] < lens.clamp(min=1)[:, None]
        lk, lv = kd.transpose(1, 2).to(bf)[None], vd.to(bf)[None]
        return lambda: F.scaled_dot_product_attention(
            q[None, :, None, :], lk, lv, attn_mask=mask[None, :, None, :],
            scale=1.0)[0, :, 0]

    # K8-ml: pair-packed int4 keys and values, (E, 2, S/2) scales
    E, dv, S2, W2 = 128 * 12, 64, S // 2, W // 2
    lens = torch.randint(0, W + 1, (E,), generator=gen, device=dev,
                         dtype=torch.int32)
    lens[0], lens[1] = 0, W - 1
    q = (randn(E, dk) * 0.125).to(bf)
    keys = torch.randint(-128, 128, (E, dk, S2), generator=gen, device=dev,
                         dtype=torch.int8)[..., :W2]
    v = torch.randint(-128, 128, (E, S2, dv), generator=gen, device=dev,
                      dtype=torch.int8)[:, :W2]
    ks = (torch.rand(E, 2, S2, generator=gen, device=dev) * 0.05)[..., :W2]
    vs = (torch.rand(E, 2, S2, generator=gen, device=dev) * 0.05)[..., :W2]
    args = (q, keys, ks, v, vs, lens)
    kd = quant.unpack_int4_pairs(keys, 2).float() * quant.interleave_pair_scales(ks)[:, None, :]
    vd = quant.unpack_int4_pairs(v, 1).float() * quant.interleave_pair_scales(vs)[..., None]
    n = lens.sum().item()
    cols = ((lens + 1) // 2).sum().item()
    cases.append(("lowbit_decode_int4_ml", f"gpt-int4-ml E={E} S={S} window={W} dv={dv}", dict(
        kernel=lambda a=args: da.decode_attention_int4_ml(*a),
        plain=lambda a=args: da.decode_attention_flat_int4_ml(*a),
        ref=lambda a=args: da.decode_attention_flat_int4_ml(a[0].float(), *a[1:]),
        library=sdpa(q, kd, vd, lens),
        bytes=q.numel() * 2 + cols * (dk + dv + 16) + E * dv * 2 + E * 12,
        flops=2 * n * (dk + dv), device_times=True)))

    # K1-ml: INT8 keys and values with per-position scales
    for label, E, dv in (("gpt-int8-ml", 128 * 12, 64),
                         ("backpack-int8-ml", 128 * 16, 768)):
        lens = torch.randint(0, W + 1, (E,), generator=gen, device=dev,
                             dtype=torch.int32)
        lens[0], lens[1] = 0, W
        q = (randn(E, dk) * 0.125).to(bf)
        kt = torch.randint(-127, 128, (E, dk, S), generator=gen, device=dev,
                           dtype=torch.int8)[..., :W]
        v = torch.randint(-127, 128, (E, S, dv), generator=gen, device=dev,
                          dtype=torch.int8)[:, :W]
        ks = (torch.rand(E, S, generator=gen, device=dev) * 0.05)[:, :W]
        vs = (torch.rand(E, S, generator=gen, device=dev) * 0.05)[:, :W]
        args = (q, kt, ks, v, vs, lens)
        n = lens.sum().item()
        cases.append(("decode_attention_ml", f"{label} E={E} S={S} window={W} dv={dv}", dict(
            kernel=lambda a=args: da.decode_attention_ml(*a),
            plain=lambda a=args: da.decode_attention_ml_ref(*a),
            ref=lambda a=args: da.decode_attention_ml_ref(a[0].float(), *a[1:]),
            library=sdpa(q, kt.float() * ks[:, None, :], v.float() * vs[..., None], lens),
            bytes=(q.numel() * 2 + n * (dk + dv + 8) + E * dv * 2 + E * 12),
            flops=2 * n * (dk + dv), device_times=True)))
    return cases


def plain_attention_by_heads(q, k, v, *, scale, p, seed, heads, grads_of=None):
    """flash_attention_ref (causal, dropout p; grads_of None: -> (out, lse))
    or flash_attention_bwd_ref (grads_of = (out, lse, dout): -> (dq, dk,
    dv)) computed over chunks of ``heads`` heads, each with the masks of its
    absolute positions (bh = b * H + h): the same function element for
    element, in pieces whose (s, s) score tensors fit the card at s 8192."""
    from backpacks_flash_attn_tpu_torch.ops import flash_attention as fa
    b, s, h, _ = q.shape
    mask = fa._valid_mask(1, s, s, True, None, None, q.device)
    pos = torch.arange(s, device=q.device)
    rows = []
    for bi in range(b):
        chunks = []
        for h0 in range(0, h, heads):
            hs = slice(h0, min(h, h0 + heads))
            bh = (bi * h + torch.arange(h0, hs.stop, device=q.device))[None, :, None, None]
            keep = fa.dropout_keep_positions(seed, bh, pos[:, None], pos[None, :], p)
            part = lambda t: t[bi:bi + 1, :, hs]
            if grads_of is None:
                chunks.append(fa._attend_ref(part(q), part(k), part(v), mask, scale, keep, p))
            else:
                out, lse, dout = grads_of
                chunks.append(fa._attend_bwd_ref(
                    part(q), part(k), part(v), part(out), lse[bi:bi + 1, hs], part(dout),
                    mask, scale, keep, p))
            del keep
        # (1, s, hc, d) tensors join along heads (dim 2), an lse (1, hc, s) on dim 1
        rows.append([torch.cat(parts, dim=2 if parts[0].dim() == 4 else 1)
                     for parts in zip(*chunks)])
    return tuple(torch.cat(parts, dim=0) for parts in zip(*rows))


def k5_case(label, q, k, v, dout, seed, p, scale, heads=None):
    """K5 against its plain version (causal, dropout p), each backward from
    its own path's forward as in training (K3's for K5: the plain bf16
    forward rounds its scores to bf16, so its LSE lies off the f32 scores K5
    recomputes, and P with it); launch-gated, with device and host times;
    library = SDPA's autograd backward (its own dropout mask, so its error
    is not reported), timed on a graph built once. ``heads``: compute the
    plain versions a few heads at a time (plain_attention_by_heads). Draws
    no random numbers. Made outside inference mode."""
    from backpacks_flash_attn_tpu_torch.ops import flash_attention as fa

    b, s, h, d = q.shape
    kw = dict(causal=True, softmax_scale=scale, dropout_p=p, seed=seed)
    q32, k32, v32, d32 = (t.float() for t in (q, k, v, dout))
    k3out, k3lse = fa._flash_fwd_kernel(q, k, v, scale=scale, seq_lengths=None,
                                        q_offsets=None, causal=True,
                                        dropout_p=p, seed=seed)
    if heads is None:
        fwd = lambda *t: fa.flash_attention_ref(*t, return_lse=True, **kw)
        bwd = lambda *t: fa.flash_attention_bwd_ref(*t, **kw)
    else:
        hk = dict(scale=scale, p=p, seed=seed, heads=heads)
        fwd = lambda *t: plain_attention_by_heads(*t, **hk)
        bwd = lambda q_, k_, v_, o_, l_, g_: plain_attention_by_heads(
            q_, k_, v_, grads_of=(o_, l_, g_), **hk)
    out, lse = fwd(q, k, v)
    out32, lse32 = fwd(q32, k32, v32)
    with torch.enable_grad():
        lq, lk, lv = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        lout = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                              scale=scale, dropout_p=p)
    ldo = dout.transpose(1, 2)
    pairs = b * h * s * (s + 1) // 2
    tensor = b * s * h * d * q.element_size()            # one (b, s, h, d)
    return ("flash_attention_bwd", label, dict(
        kernel=lambda: fa.flash_attention_bwd(q, k, v, k3out, k3lse, dout, **kw),
        plain=lambda: bwd(q, k, v, out, lse, dout),
        ref=lambda: bwd(q32, k32, v32, out32, lse32, d32),
        library=lambda: torch.autograd.grad(lout, (lq, lk, lv), ldo, retain_graph=True),
        # read q, k, v, out, dO and lse once, write dq, dk, dv; the five
        # causal products (S recomputed, dP, dV, dQ, dK)
        bytes=8 * tensor + b * h * s * 4, flops=10 * pairs * d,
        gate="flash_attention_bwd", device_times=True))


def train_kernel_cases(gen):
    """K3 with dropout, K4, K5 and K6 at the training shapes (batch 32 x
    512, backpack-small; q and k strided views, as the model makes them).
    Made outside inference mode: the library yardsticks
    of the backward kernels are autograd calls, timed on a graph built
    once (the backward alone). Their dropout masks differ from the port's,
    so their error is not reported."""
    from backpacks_flash_attn_tpu_torch.ops import backpack_kernels as bk

    bf = torch.bfloat16
    randn = lambda *s: torch.randn(*s, generator=gen, device=DEV)
    cases = []
    b, s, h, d, p = TRAIN_BATCH, TRAIN_LEN, 12, 64, 0.1
    scale = 0.125
    seed = (0x1234567, 0x89ABCDEF)
    qkv = randn(b, s, 3, h, d).to(bf)                    # strided q/k/v, as
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]   # the model makes them
    dout = randn(b, s, h, d).to(bf)
    cases.append(_k3_train_case("train", q, k, v, p, seed))
    cases.append(k5_case(f"train b={b} h={h} s={s} p={p}", q, k, v, dout, seed, p, scale))

    nv, dnv, dd = 16, 48, 768
    qk = randn(b, s, 2, nv, dnv).to(bf)
    cq, ck = qk[:, :, 0], qk[:, :, 1]
    c = randn(b, s, nv, dd).to(bf)
    g = randn(b, s, dd).to(bf)
    cases.append(k4_case("train ", cq, ck, c))
    cases.append(k6_case("train ", cq, ck, c, g))
    return cases


def k6_case(label, q, k, c, g):
    """K6 against its plain version: q, k (b, s, nv, dnv), c (b, s, nv, d),
    g = dO (b, s, d), scale dnv^-1/2. Each backward takes the LSE of its own
    path's forward, as in training (K4's for K6): the plain bf16 combine
    rounds its scores to bf16, so its LSE lies ~1e-2 off the f32 scores K6
    recomputes, and alpha with it. Launch-gated, with device and host
    times; library = SDPA's autograd backward per sense head (value width
    d, the heads summed), timed on a graph built once. Draws no random
    numbers. Made outside inference mode."""
    from backpacks_flash_attn_tpu_torch.ops import backpack_kernels as bk

    b, s, nv, dnv = q.shape
    d = c.shape[-1]
    scale = dnv ** -0.5
    pairs = b * nv * s * (s + 1) // 2
    _, klse = bk._fwd_kernel(q, k, c, scale)
    _, plse = bk.contextualization_reference(q, k, c, scale, return_lse=True)
    _, lse32 = bk.contextualization_reference(q.float(), k.float(), c.float(),
                                              scale, return_lse=True)
    with torch.enable_grad():
        hq, hk, hc = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, c))
        hout = F.scaled_dot_product_attention(hq, hk, hc, is_causal=True,
                                              scale=scale).sum(dim=1)
    return ("fused_contextualization_bwd", f"{label}b={b} s={s} nv={nv} dnv={dnv} d={d}", dict(
        kernel=lambda: bk.fused_ctx_bwd(q, k, c, klse, g, scale),
        plain=lambda: bk.fused_ctx_bwd_ref(q, k, c, plse, g, scale),
        ref=lambda: bk.fused_ctx_bwd_ref(q.float(), k.float(), c.float(),
                                         lse32, g.float(), scale),
        library=lambda: torch.autograd.grad(hout, (hq, hk, hc), g, retain_graph=True),
        # read q, k, content, dO, lse once, write dq, dk, dcontent; the
        # products S (recomputed) and dP and alpha^T dO over d, dS k and
        # dS^T q over dnv
        bytes=2 * (4 * q.numel() + 2 * c.numel() + g.numel()) + b * nv * s * 4,
        flops=2 * pairs * (3 * dnv + 2 * d),
        gate="fused_contextualization_bwd", device_times=True))


def k6_mini_cases(gen):
    """K6 at backpack-mini's widths (nv 16, dnv 40, d 640: a partial last
    column slab) at (8, 512)."""
    bf = torch.bfloat16
    qk = torch.randn(8, 512, 2, 16, 40, generator=gen, device=DEV).to(bf)
    c = torch.randn(8, 512, 16, 640, generator=gen, device=DEV).to(bf)
    g = torch.randn(8, 512, 640, generator=gen, device=DEV).to(bf)
    return [k6_case("mini ", qk[:, :, 0], qk[:, :, 1], c, g)]


# ------------------------------------------------------------------ long context

LONG_H, LONG_D, BS_BLOCK, BS_BAND = 12, 64, 256, 1024
MLP_T, MLP_D, MLP_INNER = 16384, 768, 3072     # gpt3-small's MLP at 2 x 8192
MLP_D_LARGE, MLP_INNER_LARGE = 1536, 6144       # gpt3-large's MLP widths
BS_B, BS_S = 4, 4096                            # the K9 kernel cases


def band_blockmask(s):
    """bench_longctx.py's block mask over BS_BLOCK tiles: a causal local
    band of BS_BAND positions plus the global block 0; its density against
    the causal lower triangle of blocks."""
    n = s // BS_BLOCK
    qi = torch.arange(n)[:, None]
    kj = torch.arange(n)[None, :]
    mask = ((kj <= qi) & ((qi - kj) < max(BS_BAND // BS_BLOCK, 1))) | (kj == 0)
    density = (mask.sum() / (qi >= kj).sum()).item()
    return mask.to(torch.int32).to(DEV), density


def _mlp_case(mlp, dt, rate):
    """A K7 case over the f32 draws mlp = (x, w1, b1, w2, b2) cast to dt."""
    from backpacks_flash_attn_tpu_torch.ops import fused_mlp as fm

    args = tuple(t.to(dt) for t in mlp)
    ref_args = tuple(t.float() for t in args)
    (T, d), inner = args[0].shape, args[1].shape[1]
    nbytes = (sum(t.numel() for t in args) + T * (inner + d)) * args[0].element_size()
    case = dict(
        kernel=lambda a=args: fm.mlp_fwd_fused(*a),
        plain=lambda a=args: fm.mlp_fwd_fused_ref(*a),
        ref=lambda a=ref_args: fm.mlp_fwd_fused_ref(*a),
        library=lambda a=args: F.gelu(a[0] @ a[1] + a[2], approximate="tanh") @ a[3] + a[4],
        bytes=nbytes, flops=4 * T * d * inner, flop_rate=rate)
    if dt == torch.float32:
        case["f32_rtol"] = 1e-5          # f32 sums of d_in and inner terms
    return ("fused_mlp_fwd", f"T={T} {d}->{inner}->{d} gelu_new "
            f"{str(dt).split('.')[-1]}", case)


def wide_mlp_cases(gen):
    """K7 at gpt3-large's MLP widths (16384 tokens, 1536 -> 6144 -> 1536,
    bf16). Drawn after every other phase, so that the random data of the
    phases before it stay as they were."""
    randn = lambda *s: torch.randn(*s, generator=gen, device=DEV)
    T, d, inner = MLP_T, MLP_D_LARGE, MLP_INNER_LARGE
    mlp = (randn(T, d), randn(d, inner) * 0.02, randn(inner) * 0.02,
           randn(inner, d) * 0.02, randn(d) * 0.02)
    return [_mlp_case(mlp, torch.bfloat16, PEAK_BF16_FLOP_PER_S)]


def ragged_mlp_cases(gen):
    """K7 at gpt3-small's MLP widths over 16384 - 37 tokens (bf16), whose
    last 128-row tile is partial. Drawn last of all, so that the random
    data of every phase before it stay as they were."""
    randn = lambda *s: torch.randn(*s, generator=gen, device=DEV)
    T, d, inner = MLP_T - 37, MLP_D, MLP_INNER
    mlp = (randn(T, d), randn(d, inner) * 0.02, randn(inner) * 0.02,
           randn(inner, d) * 0.02, randn(d) * 0.02)
    return [_mlp_case(mlp, torch.bfloat16, PEAK_BF16_FLOP_PER_S)]


# K2's shapes: backpack-small's INT8 linears (Wqkv, out_proj, fc1, the
# lm-head at its 50264-wide kernel case, fc2) at decode's M and the
# prefill's, and the decode step's launches of each (K, N): 12 layers x the
# four layer shapes, ctx_attn.Wqkv, the lm-head
K2_DECODE_M, K2_PREFILL_M = 128, 4096
K2_SHAPES = [(768, n, 8, None) for n in (2304, 768, 3072, 50264)] + [(3072, 768, 8, None)]
K2_DECODE_STEP = {(768, 2304): 12, (768, 768): 12, (768, 3072): 12, (3072, 768): 12,
                  (768, 1536): 1, (768, 50264): 1}


def k2_case(gen, M, K, N, bits=8, gs=None, bias=False):
    """One K2 case, launch-gated, with its device and host times: x (M, K)
    bf16 @ quantize_weight(N(0, 0.02) (K, N)), drawn in that order, library
    torch.matmul on the dequantized bf16 weight. With ``bias`` (bf16, drawn
    last) it runs through ``quant_linear``, the bias in K2's epilogue,
    checked bit-equal to K2 followed by the eager f32 add, library
    torch.addmm."""
    from backpacks_flash_attn_tpu_torch.ops import quant
    randn = lambda *s: torch.randn(*s, generator=gen, device=DEV)
    bf = torch.bfloat16
    qw = quant.quantize_weight(randn(K, N) * 0.02, bits, gs)
    x = randn(M, K).to(bf)
    wd = quant.dequantize_weight(qw, bf)
    label = f"M={M} K={K} N={N} int{bits}" + (f" g{gs}" if gs else "")
    nbytes = x.numel() * 2 + qw.q.numel() + qw.scale.numel() * 4 + M * N * 2
    run = dict(kernel=lambda: quant.quant_matmul(x, qw),
               plain=lambda: quant.quant_matmul_ref(x, qw),
               ref=lambda: quant.quant_matmul_ref(x.float(), qw),
               library=lambda: torch.matmul(x, wd))
    if bias:
        qw.bias = (randn(N) * 0.1).to(bf)
        label += " bias"
        nbytes += N * 2

        def check(out):
            if not torch.equal(out, quant._add_bias(quant.quant_matmul(x, qw), qw.bias)):
                raise AssertionError("K2's fused bias differs from the eager add")
        run = dict(kernel=lambda: quant.quant_linear(x, qw),
                   plain=lambda: quant._add_bias(quant.quant_matmul_ref(x, qw), qw.bias),
                   ref=lambda: quant._add_bias(quant.quant_matmul_ref(x.float(), qw), qw.bias),
                   library=lambda: torch.addmm(qw.bias, x, wd), check=check)
    return ("quant_matmul", label, dict(run, bytes=nbytes, flops=2 * M * K * N,
                                        gate="quant_matmul", device_times=True))


def k2_extra_cases(gen):
    """K2 at ctx_attn.Wqkv's decode shape (768 -> 1536), and fc1's with a
    bf16 bias. Drawn after every other phase, so that their random data
    stay as they were."""
    return [k2_case(gen, K2_DECODE_M, 768, 1536),
            k2_case(gen, K2_DECODE_M, 768, 3072, bias=True)]


def k2_decode_step(results):
    """The "K2 a decode step" row: each case's kernel and library
    (torch.matmul on the bf16 weight) event, device and host times and its
    bound, summed over the step's 50 launches (the kernels phase's M = 128
    INT8 per-channel cases, no bias)."""
    rows = {r["case"]: r for r in results.get("kernels", {}).get("quant_matmul", [])}
    keys = ("ms", "library_ms", "device_ms", "library_device_ms", "host_us",
            "library_host_us", "bound_ms")
    step = {"launches": 0, **{key: 0.0 for key in keys}}
    for (k, n), count in K2_DECODE_STEP.items():
        row = rows[f"M={K2_DECODE_M} K={k} N={n} int8"]
        step["launches"] += count
        for key in keys:
            step[key] += count * row[key]
    results["k2_decode_step"] = step
    emit({"phase": "kernels", "k2_decode_step": step})


def long_flash_cases(gen):
    """K3 at train-8k's per-sequence shape (1 x 8192, h 12, d 64, bf16),
    causal, dropout 0.1, where its flops bound it; library = SDPA with the
    same dropout rate (its own mask). Drawn after every other phase, so
    that the random data of the phases before it stay as they were."""
    q, k, v = (torch.randn(1, LONG_LEN, LONG_H, LONG_D, generator=gen, device=DEV)
               .to(torch.bfloat16) for _ in range(3))
    return [_k3_train_case("train8k", q, k, v, 0.1, (0x2468ACE, 0x13579BDF))]


def longctx_kernel_cases(gen):
    """K7 at the gpt3-small training MLP (16384 tokens, 768 -> 3072 -> 768,
    gelu_new) in bf16 and f32, and K9 at b 4, s 4096, h 12, d 64 under the
    band mask: the forward (out and LSE; then per-row key lengths, one
    sequence short; then a query block with no active tile), and the
    backward (dq, dk, dv in one C entry) from the kernel's own forward. q
    is pre-scaled and the blockmask int32, as flash_blocksparse_attention
    hands them to the kernels; the forward's C entry builds the tile
    tables (timed with it), the backward reads the ones its forward built,
    as in the op. Library yardsticks: matmul + gelu + matmul
    (cuBLAS); SDPA with the blockmask expanded to a dense boolean mask,
    forward and autograd backward. Made outside inference mode (the
    backward yardstick is an autograd call)."""
    from backpacks_flash_attn_tpu_torch.ops import flash_attention as fa

    bf = torch.bfloat16
    randn = lambda *s: torch.randn(*s, generator=gen, device=DEV)
    cases = []

    T, d, inner = MLP_T, MLP_D, MLP_INNER
    mlp = (randn(T, d), randn(d, inner) * 0.02, randn(inner) * 0.02,
           randn(inner, d) * 0.02, randn(d) * 0.02)
    for dt, rate in ((bf, PEAK_BF16_FLOP_PER_S), (torch.float32, PEAK_F32_FLOP_PER_S)):
        cases.append(_mlp_case(mlp, dt, rate))

    b, s, h, dh = BS_B, BS_S, LONG_H, LONG_D
    q = (randn(b, s, h, dh) * 0.125).to(bf)
    k, v, dout = (randn(b, s, h, dh).to(bf) for _ in range(3))
    bm, density = band_blockmask(s)
    lens = torch.full((b,), s, dtype=torch.int32, device=DEV)
    lens[1:] = torch.randint(1, s + 1, (b - 1,), generator=gen, device=DEV,
                             dtype=torch.int32)
    lens[0] = s // 3
    mid = bm.shape[0] // 2
    empty = bm.clone()
    empty[mid] = 0                   # query block `mid` has no active tile

    def check_empty(out):
        o, lse = out
        rows = slice(mid * BS_BLOCK, (mid + 1) * BS_BLOCK)
        if not ((o[:, rows] == 0).all() and (lse[:, :, rows] == fa.NEG_INF).all()):
            raise AssertionError("blocksparse_fwd: a query block with no active "
                                 "tile gave a non-zero row or a finite LSE")

    for label, mask, seq in (("band", bm, None), ("ragged", bm, lens),
                             ("empty-row", empty, None)):
        case = k9_fwd_case(q, k, v, mask, True, BS_BLOCK, seq)
        if label == "empty-row":
            case["check"] = check_empty
        cases.append(("blocksparse_fwd", f"{label} b={b} h={h} s={s} "
                      f"density={density:.3f}", case))
    cases.append(("blocksparse_bwd", f"band b={b} h={h} s={s}",
                  k9_bwd_case(q, k, v, dout, bm, True, BS_BLOCK)))
    return cases


def _k9_pairs(q, k, act, causal, block, seq=None):
    """The valid (query, key) pairs of a K9 call and its dense mask."""
    from backpacks_flash_attn_tpu_torch.ops import flash_attention as fa
    b, sq, h = q.shape[:3]
    emask = fa._bs_mask(act, b, sq, k.shape[1], block, block, causal, seq)
    return int(emask.sum().item()) * h, emask


def k9_fwd_case(q, k, v, mask, causal, block, seq=None):
    """K9's forward C entry (the tile tables built from the int32 blockmask,
    then out and LSE over pre-scaled bf16 q) against the plain forward over
    the active tiles; library = SDPA under the dense boolean mask. Draws
    nothing."""
    from backpacks_flash_attn_tpu_torch.ops import flash_attention as fa
    b, sq, h, dh = q.shape
    act = fa.blocksparse_active(mask, causal, block, block)
    pairs, emask = _k9_pairs(q, k, act, causal, block, seq)
    kw = dict(causal=causal, block_q=block, block_k=block, seq_lengths=seq)
    q32, k32, v32 = q.float(), k.float(), v.float()
    qT, kT, vT = (t.transpose(1, 2) for t in (q, k, v))
    return dict(
        kernel=lambda: fa._bs_fwd_kernel(q, k, v, mask, **kw)[:2],
        plain=lambda: fa.blocksparse_attention_ref(q, k, v, act, **kw),
        ref=lambda: fa.blocksparse_attention_ref(q32, k32, v32, act, **kw),
        library=lambda: F.scaled_dot_product_attention(
            qT, kT, vT, attn_mask=emask, scale=1.0).transpose(1, 2),
        # read q, k, v once, write out and the LSE; the two products over
        # the valid pairs
        bytes=q.element_size() * (2 * q.numel() + 2 * k.numel()) + b * h * sq * 4,
        flops=4 * pairs * dh)


def k9_bwd_case(q, k, v, dout, mask, causal, block):
    """K9's backward C entry (over the tables its forward built) from the
    kernel's own forward, against the plain backward from the plain
    forward; library = SDPA's autograd backward under the dense boolean
    mask. Draws nothing."""
    from backpacks_flash_attn_tpu_torch.ops import flash_attention as fa
    b, sq, h, dh = q.shape
    act = fa.blocksparse_active(mask, causal, block, block)
    pairs, emask = _k9_pairs(q, k, act, causal, block)
    kw = dict(causal=causal, block_q=block, block_k=block)
    q32, k32, v32 = q.float(), k.float(), v.float()
    kout, klse, tables = fa._bs_fwd_kernel(q, k, v, mask, **kw)
    pout, plse = fa.blocksparse_attention_ref(q, k, v, act, **kw)
    rout, rlse = fa.blocksparse_attention_ref(q32, k32, v32, act, **kw)
    with torch.enable_grad():
        lq, lk, lv = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        lout = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=emask, scale=1.0)
    ldo = dout.transpose(1, 2)
    return dict(
        kernel=lambda: fa._bs_bwd_kernel(q, k, v, kout, klse, dout, tables, **kw),
        plain=lambda: fa.blocksparse_attention_bwd_ref(q, k, v, pout, plse, dout, act, **kw),
        ref=lambda: fa.blocksparse_attention_bwd_ref(q32, k32, v32, rout, rlse,
                                                     dout.float(), act, **kw),
        library=lambda: torch.autograd.grad(lout, (lq, lk, lv), ldo, retain_graph=True),
        # read q, k, v, out, dO once, write dq, dk, dv (8 tensors), and
        # two f32 rows (the LSE read, delta made and read); the five
        # products (S recomputed, dP, dV, dQ, dK) over the valid pairs
        bytes=q.element_size() * 4 * (q.numel() + k.numel()) + 2 * b * h * sq * 4,
        flops=10 * pairs * dh)


K9_CAP_LEN, K9_CAP_SHORT, K9_CAP_BLOCK = 33280, 128, 64


def k9_past_cap_cases(gen):
    """K9 past the old kernels' 512-block cap, at block 64, non-causal, a
    random blockmask of density ~0.5, b 1, h 12: the forward with sq 128
    over sk 33,280 (520 key blocks a row) and the backward with sq 33,280
    over sk 128 (520 query blocks a column). Drawn after every other
    phase's data, so that their inputs stay as they were."""
    randn = lambda *s: torch.randn(*s, generator=gen, device=DEV)
    bf = torch.bfloat16
    cases = []
    h, dh, blk = LONG_H, LONG_D, K9_CAP_BLOCK
    for label, sq, sk in (("past-cap fwd", K9_CAP_SHORT, K9_CAP_LEN),
                          ("past-cap bwd", K9_CAP_LEN, K9_CAP_SHORT)):
        q = (randn(1, sq, h, dh) * 0.125).to(bf)
        k, v = (randn(1, sk, h, dh).to(bf) for _ in range(2))
        dout = randn(1, sq, h, dh).to(bf)
        n_qb, n_kb = -(-sq // blk), -(-sk // blk)
        mask = (torch.rand(n_qb, n_kb, generator=gen, device=DEV) < 0.5).to(torch.int32)
        shape = f"sq={sq} sk={sk} block={blk} blocks={max(n_qb, n_kb)} h={h}"
        if label.endswith("fwd"):
            cases.append(("blocksparse_fwd", f"{label} {shape}",
                          k9_fwd_case(q, k, v, mask, False, blk)))
        else:
            cases.append(("blocksparse_bwd", f"{label} {shape}",
                          k9_bwd_case(q, k, v, dout, mask, False, blk)))
    return cases


def long_flash_bwd_cases(gen):
    """K5 at train-8k's shape (2 x 8192, h 12, d 64, bf16), causal, dropout
    0.1, where its flops bound it (0.52 ms); library = SDPA's backward. The
    plain versions run four heads at a time. Drawn after every other
    phase's data, so that their inputs stay as they were."""
    randn = lambda *s: torch.randn(*s, generator=gen, device=DEV)
    b, s, h, d, p = LONG_BATCH, LONG_LEN, LONG_H, LONG_D, 0.1
    q, k, v, dout = (randn(b, s, h, d).to(torch.bfloat16) for _ in range(4))
    return [k5_case(f"train8k b={b} h={h} s={s} p={p}", q, k, v, dout,
                    (0x2468ACE, 0x13579BDF), p, d ** -0.5, heads=4)]


# the case whose numbers stand for each kernel in the {"kernels"} line: the
# one the INT8 decode step (K1, K2), the INT8 prefill (K3), the forward
# (K4), the training step (K5, K6), the 8k training step (K7) and the
# long-context block-sparse run (K9) run
HEADLINE = {
    "decode_attention": "backpack-int8",
    "quant_matmul": "M=128 K=768 N=50264 int8",
    "flash_attention": "prefill",
    "fused_contextualization": "b=8",
    "flash_attention_bwd": "train",
    "fused_contextualization_bwd": "train",
    "lowbit_decode_int4": "gpt-int4",
    "lowbit_decode_mixed": "backpack-mixed",
    "decode_attention_ml": "gpt-int8-ml",
    "lowbit_decode_int4_ml": "gpt-int4-ml",
    "fused_mlp_fwd": f"T={MLP_T} {MLP_D}->{MLP_INNER}->{MLP_D} gelu_new bfloat16",
    "blocksparse_fwd": "band",
    "blocksparse_bwd": "band",
    "decode_attention_gathered": "gpt-generate",
    "decode_attention_selector": "gpt_kv-int8 S=512 full vt=True",
    "decode_attention_blockdiag": "gpt_kv-int8 S=512 full",
}
# the run whose launch counts stand for each kernel in that line
LAUNCH_RUN = {
    "decode_attention": "serve_int8",
    "quant_matmul": "serve_int8",
    "flash_attention": "serve_int8",
    "fused_contextualization": "forward",
    "flash_attention_bwd": "train_einsum",
    "fused_contextualization_bwd": "train_fused",
    "lowbit_decode_int4": "serve_int4",
    "lowbit_decode_mixed": "serve_int4",
    "decode_attention_ml": "serve_engine",
    "lowbit_decode_int4_ml": "serve_staged_kv4",
    "fused_mlp_fwd": "train_8k",
    "blocksparse_fwd": "longctx",
    "blocksparse_bwd": "longctx",
    "decode_attention_gathered": "decode_kernels",
    "decode_attention_selector": "decode_kernels",
    "decode_attention_blockdiag": "decode_kernels",
}


def phase_kernels(cases, results):
    """Each case: the kernel against its plain version under the 2x rule
    (an f32 case, whose plain version is its reference, within
    ``f32_rtol`` of the reference's largest magnitude instead), an optional
    ``check`` of the kernel's output, and the times. A case with ``gate``
    first runs its call alone, the launch counts reset just before and read
    just after: it must launch kernel ``gate`` exactly once and no other."""
    from backpacks_flash_attn_tpu_torch.ops import _build
    made = []
    for name, label, c in cases:
        launches = None
        if "gate" in c:
            _build.reset_launches()
            c["kernel"]()
            torch.cuda.synchronize()
            launches = {k: n for k, n in _build.launch_counts().items() if n}
            if launches != {c["gate"]: 1}:
                raise AssertionError(f"{name} [{label}]: launches {launches}, "
                                     f"want {c['gate']} once")
        out, plain, ref = c["kernel"](), c["plain"](), c["ref"]()
        torch.cuda.synchronize()
        if "f32_rtol" in c:
            outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
            ek, ep = max(max_err(o, r) for o, r in zip(outs, refs)), None
            scale = max(r.abs().max().item() for r in refs)
            if ek > c["f32_rtol"] * max(1.0, scale):
                raise AssertionError(f"{name} [{label}]: f32 kernel error {ek:.3e} "
                                     f"> {c['f32_rtol']} x {scale:.3e}")
        else:
            ek, ep = two_x(f"{name} [{label}]", out, plain, ref)
        if "check" in c:
            c["check"](out)
        lib_out = c["library"]()
        lib_err = (max_err(lib_out, ref) if isinstance(lib_out, torch.Tensor)
                   and isinstance(ref, torch.Tensor) and "dropout" not in label
                   else None)
        row = dict(case=label, max_abs_err=ek, plain_bf16_err=ep,
                   library_err=lib_err,
                   ms=time_ms(c["kernel"]), plain_ms=time_ms(c["plain"]),
                   library_ms=time_ms(c["library"]))
        if c.get("device_times"):
            row["device_ms"], row["device_launches"] = device_ms(c["kernel"])
            row["library_device_ms"], row["library_device_launches"] = device_ms(c["library"])
            row.update(host_us=host_us(c["kernel"]), library_host_us=host_us(c["library"]))
        row["bound_ms"], row["bound_by"] = bound(
            c["bytes"], c["flops"], c.get("flop_rate", PEAK_BF16_FLOP_PER_S))
        if launches is not None:
            row["launches"] = launches
        results.setdefault(name, []).append(row)
        made.append(row)
        emit({"phase": "kernels", "kernel": name, **row})
        del out, plain, ref, lib_out
    _build.reset_launches()
    return made


# ------------------------------------------------------------------ serve

BATCH, PROMPT, MAX_LEN = 128, 32, 512
SEGMENTS = [(128 - PROMPT, 128), (128, 256)]      # 224 greedy tokens
SHORT_PROFILE = [(32, 128)]       # the stretch the low-bit runs profile
COMPARE_STEPS = 8
FWD_BATCH, FWD_LEN = 8, 512
# the serve runs' cache configurations (init_backpack_cache keywords)
CACHES = {
    "bf16": dict(dtype=torch.bfloat16),
    "f32": dict(dtype=torch.float32),
    "int8": dict(dtype=torch.int8),
    "kv4": dict(dtype=torch.int8, bits=8, kv_bits=4),    # INT8 ctx-K/senses, int4 GPT KV
    "int4": dict(dtype=torch.int8, bits=4),              # mixed ctx-K/senses, int4 GPT KV
}


def new_cache(cfg, cache):
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    return bp.init_backpack_cache(cfg, BATCH, MAX_LEN, **CACHES[cache])


def decode(model_params, cfg, cache, token, segments, record=None):
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    for n_steps, window in segments:
        for _ in range(n_steps):
            logits, cache = bp.backpack_forward_with_cache(
                model_params, cfg, token, cache, window=window)
            token = logits[:, -1].argmax(-1)[:, None]
            if record is not None and len(record) < COMPARE_STEPS:
                record.append(token)
    return token


SERVE_PASSES = 3


def serve_once(params, cfg, cache, prompt, tokens=None, segments=SEGMENTS):
    """One prefill + the greedy tokens of `segments` on a fresh cache:
    (prefill s, decode s, the launch counts read right after the prefill);
    the generated tokens are appended to `tokens`."""
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    from backpacks_flash_attn_tpu_torch.ops import _build
    kv = new_cache(cfg, cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, kv = bp.backpack_forward_with_cache(params, cfg, prompt, kv)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = _build.launch_counts()
    first = logits[:, -1].argmax(-1)[:, None]
    if tokens is not None:
        tokens.append(first)
    decode(params, cfg, kv, first, segments, tokens)
    torch.cuda.synchronize()
    return t1 - t0, time.perf_counter() - t1, counts


def serve_run(label, params, cfg, cache, prompt):
    """The main path, SERVE_PASSES times after a warm-up: returns the run's
    record (median prefill/decode times, tokens/s, the launch counts of
    the first pass alone, of its prefill and per decode step) and the
    first pass's tokens."""
    from backpacks_flash_attn_tpu_torch.ops import _build

    # warm-up on a throwaway cache (allocator, cuBLAS heuristics)
    serve_once(params, cfg, cache, prompt, segments=[(4, 128)])

    tokens = []
    _build.reset_launches()
    first = serve_once(params, cfg, cache, prompt, tokens)
    counts = _build.launch_counts()
    times = [first[:2]] + [serve_once(params, cfg, cache, prompt)[:2]
                           for _ in range(SERVE_PASSES - 1)]
    steps = sum(n for n, _ in SEGMENTS)
    n_tokens = BATCH * steps
    decode_s = statistics.median(t for _, t in times)
    out = dict(phase="serve", run=label, cache=cache,
               prefill_s=statistics.median(p for p, _ in times),
               decode_s=decode_s, decode_s_passes=[t for _, t in times],
               decode_tokens=n_tokens, tokens_per_s=n_tokens / decode_s,
               launches=counts, launches_prefill=first[2],
               launches_per_decode_step={k: (counts[k] - first[2][k]) / steps
                                         for k in counts})
    emit(out)
    return out, torch.cat(tokens, dim=1)


def _kernel_profile(fn):
    """fn() under torch.profiler, kernel events only (the host ops' events
    are not read: summing them over 224 decode steps took the profiler
    about a minute a run): its wall seconds and (device us, kernel, calls)
    rows, largest first."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    return wall, rows


def k1_per_step(rows, steps):
    """K1's device ms and recorded launches a step (both forms share one
    kernel symbol) from a profile's (device us, kernel, calls) rows."""
    mine = [(us, c) for us, k, c in rows if "decode_attention_kernel" in k]
    return dict(k1_device_ms_per_step=sum(us for us, _ in mine) / 1e3 / steps,
                k1_recorded_launches_per_step=sum(c for _, c in mine) / steps)


def k8_per_step(rows, steps):
    """K8's device ms and recorded launches a step (its forms, K8-ml
    included, share one kernel symbol) from a profile's rows."""
    mine = [(us, c) for us, k, c in rows if "lowbit_decode" in k]
    return dict(k8_device_ms_per_step=sum(us for us, _ in mine) / 1e3 / steps,
                k8_recorded_launches_per_step=sum(c for _, c in mine) / steps)


def _per_step(wall, rows, steps, top=12):
    return dict(steps=steps, wall_ms_per_step_profiled=wall * 1e3 / steps,
                device_ms_per_step=sum(us for us, _, _ in rows) / 1e3 / steps,
                k2_device_ms_per_step=sum(us for us, k, _ in rows
                                          if "quant_matmul" in k) / 1e3 / steps,
                **k1_per_step(rows, steps), **k8_per_step(rows, steps),
                top=[dict(name=k[:80], ms_per_step=us / 1e3 / steps,
                          calls_per_step=c / steps) for us, k, c in rows[:top]])


def profile_decode(params, cfg, cache, prompt, segments):
    """Device time by kernel over the decode steps of `segments` after a
    fresh prefill."""
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    steps = sum(n for n, _ in segments)
    kv = new_cache(cfg, cache)
    logits, kv = bp.backpack_forward_with_cache(params, cfg, prompt, kv)
    token = logits[:, -1].argmax(-1)[:, None]
    wall, rows = _kernel_profile(lambda: decode(params, cfg, kv, token, segments))
    del kv
    return dict(_per_step(wall, rows, steps), segments=segments)


def teacher_forced(params, ref_params, cfg, cache, ref_cache, prompt, gen_tokens):
    """Logits of the first COMPARE_STEPS decode steps (and the prefill) on
    the same tokens: kernel path, plain path, f32 plain reference."""
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    from backpacks_flash_attn_tpu_torch.ops import _build

    caches = {"kernel": new_cache(cfg, cache), "plain": new_cache(cfg, cache),
              "ref": new_cache(cfg, ref_cache)}
    errs = {"kernel": 0.0, "plain": 0.0, "kernel_vs_plain": 0.0}
    chunks = [(prompt, None)] + [(gen_tokens[:, i:i + 1], 128)
                                 for i in range(COMPARE_STEPS)]
    for ids, window in chunks:
        outs = {}
        for path in ("kernel", "plain", "ref"):
            p = ref_params if path == "ref" else params
            if path == "kernel":
                logits, _ = bp.backpack_forward_with_cache(p, cfg, ids, caches[path],
                                                           window=window)
            else:
                with _build.plain_path():
                    logits, _ = bp.backpack_forward_with_cache(
                        p, cfg, ids, caches[path], window=window)
            outs[path] = logits.float()
        for path in ("kernel", "plain"):
            errs[path] = max(errs[path], max_err(outs[path], outs["ref"]))
        errs["kernel_vs_plain"] = max(errs["kernel_vs_plain"],
                                      max_err(outs["kernel"], outs["plain"]))
    if not (errs["plain"] > 0 and errs["kernel"] <= 2 * errs["plain"]):
        raise AssertionError(f"teacher-forced logits: kernel error "
                             f"{errs['kernel']:.3e} > 2x plain {errs['plain']:.3e}")
    return errs


def _check_lowbit_launches(run, cfg):
    """Per decode step: K8 over the int4 GPT KV once per layer in both
    low-bit runs; the Backpack combine by K8 over the mixed cache (int4)
    or by K1 over the INT8 ctx-K/senses (kv4); K3 once per layer in the
    prefill."""
    per_step, prefill = run["launches_per_decode_step"], run["launches_prefill"]
    mixed = run["cache"] == "int4"
    want = {"lowbit_decode_int4": cfg.n_layer, "lowbit_decode_mixed": int(mixed),
            "decode_attention": int(not mixed)}
    for name, n in want.items():
        if per_step[name] != n:
            raise AssertionError(f"serve {run['run']}: {name} launched "
                                 f"{per_step[name]} times a decode step, want {n}")
    if per_step["quant_matmul"] <= 0 or prefill["flash_attention"] != cfg.n_layer:
        raise AssertionError(f"serve {run['run']}: launches {run['launches']}")


def phase_serve(gen, results):
    from backpacks_flash_attn_tpu_torch.config import backpack_small
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    from backpacks_flash_attn_tpu_torch.models import quantized as qz

    cfg = backpack_small(vocab_size=50257)
    params = bp.init_backpack(cfg, gen, dtype=torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device=DEV)

    log("serve: bf16")
    run, gen_tokens = serve_run("bf16", params, cfg, "bf16", prompt)
    params32 = _map_tensors(params, lambda t: t.float())
    _teacher_forced_gate(run, params, params32, cfg, "f32", prompt, gen_tokens)
    del params32
    _add_profile(run, params, cfg, prompt)
    results["serve_bf16"] = run

    log("serve: int8 (quantizing)")
    qparams = qz.quantize_backpack_params(params, cfg, bits=8)
    # the f32 reference: the same INT8 codes and scales, f32 activations
    q32 = qz.quantize_backpack_params(params, cfg, bits=8,
                                      act_dtype=torch.float32)
    del params
    torch.cuda.empty_cache()
    run, gen_tokens = serve_run("int8", qparams, cfg, "int8", prompt)
    counts = run["launches"]
    for name in ("decode_attention", "quant_matmul", "flash_attention"):
        if counts[name] <= 0:
            raise AssertionError(f"INT8 serve run launched {name} no time")
    _teacher_forced_gate(run, qparams, q32, cfg, "int8", prompt, gen_tokens)
    _add_profile(run, qparams, cfg, prompt)
    results["serve_int8"] = run

    # the low-bit caches under the same INT8 weights: (8, 4) INT8 senses
    # with int4 KV, (4, None) the mixed cache with int4 KV; each profiles
    # a short stretch of its decode
    for label in ("kv4", "int4"):
        log(f"serve: {label}")
        run, gen_tokens = serve_run(label, qparams, cfg, label, prompt)
        _check_lowbit_launches(run, cfg)
        _teacher_forced_gate(run, qparams, q32, cfg, label, prompt, gen_tokens)
        _add_profile(run, qparams, cfg, prompt, SHORT_PROFILE)
        results[f"serve_{label}"] = run
    return cfg


def _teacher_forced_gate(run, params, ref_params, cfg, ref_cache, prompt, gen_tokens):
    errs = teacher_forced(params, ref_params, cfg, run["cache"], ref_cache, prompt,
                          gen_tokens)
    run["teacher_forced_max_abs_err"] = errs["kernel"]
    run["teacher_forced_plain_bf16_err"] = errs["plain"]
    emit({"phase": "serve", "run": run["run"], "teacher_forced": errs})


def _add_profile(run, params, cfg, prompt, segments=SEGMENTS):
    """Idle share = 1 - device ms / wall ms per step, both over the same
    steps: against unprofiled wall time (for SEGMENTS the timed passes'
    median, the headline; for a shorter stretch one unprofiled decode of
    it) and against the profiled run itself (which carries the profiler's
    host overhead). No clamp: a negative share would expose an
    inconsistent reading."""
    prof = profile_decode(params, cfg, run["cache"], prompt, segments)
    steps = sum(n for n, _ in segments)
    if segments == SEGMENTS:
        step_ms = run["decode_s"] * 1e3 / steps
    else:
        step_ms = serve_once(params, cfg, run["cache"], prompt,
                             segments=segments)[1] * 1e3 / steps
    prof["wall_ms_per_step"] = step_ms
    prof["device_idle_share"] = 1 - prof["device_ms_per_step"] / step_ms
    prof["device_idle_share_profiled"] = (
        1 - prof["device_ms_per_step"] / prof["wall_ms_per_step_profiled"])
    prof["profiler_wall_overhead"] = prof["wall_ms_per_step_profiled"] / step_ms - 1
    run["profile"] = prof
    emit({"phase": "serve", "run": run["run"], "profile": prof})


def _map_tensors(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    return fn(tree)


# ------------------------------------------------------------------ engine

ENGINE_SLOTS, ENGINE_REQUESTS, ENGINE_PROFILE = 128, 256, (64, 32)
ENGINE_PROMPT, ENGINE_NEW = (16, 64), (64, 224)
STAGE = 64                    # ServingEngine's default stage_tokens
GATE_STAGE, GATE_LENS = 4, (16, 24, 32, 40)


def gemms(cfg):
    """K2 launches of one forward over INT8 weights: the four linears of
    each GPT layer, ctx_attn.Wqkv and the lm head (the senses are a
    gathered table)."""
    return 4 * cfg.n_layer + 2


def engine_requests(cfg, gen):
    """ENGINE_REQUESTS greedy requests from the seeded generator: prompts of
    16-64 tokens, budgets of 64-224 new tokens."""
    n = ENGINE_REQUESTS
    lens = torch.randint(ENGINE_PROMPT[0], ENGINE_PROMPT[1] + 1, (n,),
                         generator=gen, device=DEV).tolist()
    budgets = torch.randint(ENGINE_NEW[0], ENGINE_NEW[1] + 1, (n,),
                            generator=gen, device=DEV).tolist()
    ids = torch.randint(0, cfg.vocab_size, (n, ENGINE_PROMPT[1]),
                        generator=gen, device=DEV).tolist()
    return [(ids[i][:lens[i]], budgets[i]) for i in range(n)]


def new_engine(params, cfg, **kw):
    """The engine at its defaults over INT8 caches, ENGINE_SLOTS slots (kw:
    the intervention tables and options)."""
    from backpacks_flash_attn_tpu_torch.serving.engine import ServingEngine
    return ServingEngine(params, cfg, max_slots=ENGINE_SLOTS,
                         max_seqlen=MAX_LEN, cache_dtype=torch.int8, eos_id=-1,
                         stage_tokens=STAGE, **kw)


def submit_all(eng, requests):
    """Submit (prompt, budget[, submit keywords]) requests -> their ids."""
    return [eng.submit(r[0], max_new_tokens=r[1], **(r[2] if len(r) > 2 else {}))
            for r in requests]


def engine_run(params, cfg, requests, **engine_kw):
    """Serve every request to completion on a fresh engine: (tokens per
    request, stats())."""
    eng = new_engine(params, cfg, **engine_kw)
    rids = submit_all(eng, requests)
    results = eng.run()
    torch.cuda.synchronize()
    stats = eng.stats()
    del eng
    return [results[r].tokens for r in rids], stats


# the port's kernels on the engine's path, by profiler symbol: K1 (both
# forms), K2, K3; the rest of a step's device time is eager PyTorch ops
ENGINE_KERNEL_SYMBOLS = ("decode_attention_kernel", "quant_matmul", "flash_fwd")


def profile_engine(params, cfg, requests, **engine_kw):
    """Wall ms per step of ENGINE_PROFILE[1] steps after ENGINE_PROFILE[0]
    (past the first admission wave), unprofiled, then device ms per step by
    kernel over the next as many steps with torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    eng = new_engine(params, cfg, **engine_kw)
    submit_all(eng, requests)
    skip, steps = ENGINE_PROFILE
    for _ in range(skip):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    # kernel events only: the host ops' events would slow the profiler's
    # summary by a minute and are not read
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_prof = (time.perf_counter() - t0) * 1e3 / steps
    iv_steps = eng.stats().get("intervention_steps", 0)
    del eng
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    device = sum(us for us, _, _ in rows) / 1e3 / steps
    kernels = sum(us for us, k, _ in rows
                  if any(n in k for n in ENGINE_KERNEL_SYMBOLS)) / 1e3 / steps
    return dict(steps=steps, after_steps=skip, wall_ms_per_step=wall,
                wall_ms_per_step_profiled=wall_prof,
                device_ms_per_step=device,
                device_idle_share=1 - device / wall,
                device_idle_share_profiled=1 - device / wall_prof,
                intervention_steps_to_profile_end=iv_steps,
                k2_device_ms_per_step=sum(us for us, k, _ in rows
                                          if "quant_matmul" in k) / 1e3 / steps,
                eager_device_ms_per_step=device - kernels,
                eager_share_of_device=(device - kernels) / device if device else None,
                **k1_per_step(rows, steps),
                top=[dict(name=k[:80], ms_per_step=us / 1e3 / steps,
                          calls_per_step=c / steps) for us, k, c in rows[:12]])


def phase_engine(gen, results):
    """serve-engine: ServingEngine over INT8 weights and INT8 caches at its
    defaults (stage 64, windows 128/256/384/512), 128 slots, 256 greedy
    requests; serve-staged-kv4: the model path over the staged int4-KV
    cache; then the teacher-forced gates of both staged configurations."""
    from backpacks_flash_attn_tpu_torch.config import backpack_small
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    from backpacks_flash_attn_tpu_torch.models import quantized as qz
    from backpacks_flash_attn_tpu_torch.ops import _build

    cfg = backpack_small(vocab_size=50257)
    params = bp.init_backpack(cfg, gen, dtype=torch.bfloat16)
    qparams = qz.quantize_backpack_params(params, cfg, bits=8)
    q32 = qz.quantize_backpack_params(params, cfg, bits=8,
                                      act_dtype=torch.float32)
    del params
    requests = engine_requests(cfg, gen)

    log("engine: warm-up")
    engine_run(qparams, cfg, [(p, 8) for p, _ in requests[:ENGINE_SLOTS]])
    log("engine: serve-engine")
    _build.reset_launches()
    tokens, stats = engine_run(qparams, cfg, requests)
    counts = _build.launch_counts()
    D, P, G = stats["decode_steps"], stats["prefill_dispatches"], gemms(cfg)
    want = {"decode_attention_ml": (cfg.n_layer + 1) * D, "decode_attention": 0,
            "quant_matmul": G * (D + P), "flash_attention": cfg.n_layer * P}
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"serve-engine: {name} launched {counts[name]} "
                                 f"times, want {n} ({D} steps, {P} prefills)")
    if stats["completed"] != ENGINE_REQUESTS or not stats.get("flushes"):
        raise AssertionError(f"serve-engine: stats {stats}")
    if any(len(t) != n for t, (_, n) in zip(tokens, requests)):
        raise AssertionError("serve-engine: a request ended early")
    log("engine: plain path")
    with _build.plain_path():
        plain_tokens, plain_stats = engine_run(qparams, cfg, requests)
    same = sum(a == b for a, b in zip(tokens, plain_tokens)) / len(tokens)
    run = dict(phase="engine", run="serve_engine", stats=stats, launches=counts,
               launches_per_decode_step={
                   "decode_attention_ml": counts["decode_attention_ml"] / D,
                   "decode_attention": counts["decode_attention"] / D,
                   "quant_matmul": (counts["quant_matmul"] - G * P) / D},
               share_equal_to_plain_path=same,
               plain_path_tokens_per_s=plain_stats["tokens_per_s"])
    log("engine: profile")
    run["profile"] = profile_engine(qparams, cfg, requests)
    emit(run)
    results["serve_engine"] = run

    log("engine: serve-staged-kv4")
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device=DEV)
    results["serve_staged_kv4"] = staged_kv4_run(qparams, cfg, prompt)

    log("engine: staged teacher-forced gates")
    gates = {}
    for label, kw in (("int8", CACHES["int8"]), ("kv4", CACHES["kv4"])):
        gates[label] = staged_gate(qparams, q32, cfg, kw, gen)
        emit({"phase": "engine", "staged_gate": label, **gates[label]})
    results["staged_gates"] = gates


def staged_prefill(params, cfg, prompts, lens, cache_kw, stage):
    """A per-slot staged cache whose rows are prefilled in groups at scalar
    lengths (int4 caches take multi-token writes at a uniform offset only)
    and inserted as the engine admits them. Returns (cache, last logits)."""
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    b = prompts.shape[0]
    cache = bp.init_backpack_cache(cfg, b, MAX_LEN, per_slot=True, stage=stage,
                                   **cache_kw)
    group = b // len(lens)
    last = []
    for g, n in enumerate(lens):
        small = bp.init_backpack_cache(cfg, group, MAX_LEN, **cache_kw)
        logits, small = bp.backpack_forward_with_cache(
            params, cfg, prompts[g * group:(g + 1) * group, :n], small)
        for i in range(group):
            bp.insert_cache_slot(cache, bp.extract_cache_slot(small, i, cfg),
                                 g * group + i)
        last.append(logits[:, -1])
        del small
    return cache, torch.cat(last)


def staged_kv4_once(params, cfg, prompt, segments, record=None):
    """Prefill at a scalar length and insert, then greedy steps over the
    staged int4-KV cache, flushing whenever STAGE staged columns fill:
    (decode s, flushes)."""
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    cache, last = staged_prefill(params, cfg, prompt, (PROMPT,), CACHES["kv4"],
                                 STAGE)
    token = last.argmax(-1)[:, None]
    torch.cuda.synchronize()
    t0, flushes = time.perf_counter(), 0
    for n_steps, window in segments:
        for _ in range(n_steps):
            if cache.gpt.stage_ptr == STAGE:
                bp.flush_cache(cache)
                flushes += 1
            logits, cache = bp.backpack_forward_with_cache(
                params, cfg, token, cache, window=window)
            token = logits[:, -1].argmax(-1)[:, None]
            if record is not None:
                record.append(token)
    torch.cuda.synchronize()
    del cache
    return time.perf_counter() - t0, flushes


def staged_kv4_run(params, cfg, prompt):
    """serve-staged-kv4: 128 prompts of 32 tokens, then 224 greedy steps
    under windows 128/256 over the staged int4-KV cache (INT8 ctx-K and
    senses): per decode step K8-ml once per GPT layer and K1-ml once for
    the combine. Decode s median of SERVE_PASSES after a warm-up; device
    time by kernel over a 32-step stretch."""
    from torch.profiler import ProfilerActivity, profile

    from backpacks_flash_attn_tpu_torch.ops import _build
    staged_kv4_once(params, cfg, prompt, [(4, 128)])
    _build.reset_launches()
    toks = []
    first = staged_kv4_once(params, cfg, prompt, SEGMENTS, toks)
    counts = _build.launch_counts()
    times = [first[0]] + [staged_kv4_once(params, cfg, prompt, SEGMENTS)[0]
                          for _ in range(SERVE_PASSES - 1)]
    steps = sum(n for n, _ in SEGMENTS)
    per_step = {k: v / steps for k, v in counts.items()}
    want = {"lowbit_decode_int4_ml": cfg.n_layer, "decode_attention_ml": 1,
            "decode_attention": 0, "lowbit_decode_int4": 0}
    # the prefill launches K2 and K3 too; the rest are the decode steps'
    prefill = {"quant_matmul": gemms(cfg), "flash_attention": cfg.n_layer}
    per_step.update({k: (counts[k] - n) / steps for k, n in prefill.items()})
    for name, n in want.items():
        if per_step[name] != n:
            raise AssertionError(f"serve-staged-kv4: {name} launched "
                                 f"{per_step[name]} times a step, want {n}")
    decode_s = statistics.median(times)
    short = SHORT_PROFILE[0][0]
    wall = staged_kv4_once(params, cfg, prompt, SHORT_PROFILE)[0] * 1e3 / short
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        staged_kv4_once(params, cfg, prompt, SHORT_PROFILE)
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    device = sum(us for us, _, _ in rows) / 1e3 / short
    out = dict(phase="engine", run="serve_staged_kv4", decode_s=decode_s,
               decode_s_passes=times, tokens_per_s=BATCH * steps / decode_s,
               flushes=first[1], launches=counts,
               launches_per_decode_step=per_step,
               profile=dict(steps=short, wall_ms_per_step=wall,
                            device_ms_per_step=device,
                            device_idle_share=1 - device / wall,
                            **k1_per_step(rows, short), **k8_per_step(rows, short),
                            top=[dict(name=k[:80], ms_per_step=us / 1e3 / short,
                                      calls_per_step=c / short)
                                 for us, k, c in rows[:12]]))
    emit(out)
    return out


def staged_gate(params, ref_params, cfg, cache_kw, gen):
    """Teacher-forced logits of COMPARE_STEPS decode steps over a staged
    cache of BATCH slots with ragged lengths (four groups prefilled at 16,
    24, 32 and 40 tokens), a GATE_STAGE-column stage so that a flush falls
    inside the steps: kernel path vs plain path vs the f32 plain reference
    (the same INT8 codes, f32 activations), under the 2x rule."""
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    from backpacks_flash_attn_tpu_torch.ops import _build

    prompts = torch.randint(0, cfg.vocab_size, (BATCH, max(GATE_LENS)),
                            generator=gen, device=DEV)
    toks = torch.randint(0, cfg.vocab_size, (BATCH, COMPARE_STEPS),
                         generator=gen, device=DEV)
    outs = {}
    for path in ("kernel", "plain", "ref"):
        p = ref_params if path == "ref" else params
        ctx = contextlib.nullcontext() if path == "kernel" else _build.plain_path()
        with ctx:
            cache, _ = staged_prefill(p, cfg, prompts, GATE_LENS, cache_kw,
                                      GATE_STAGE)
            logits, flushes = [], 0
            for t in range(COMPARE_STEPS):
                if cache.gpt.stage_ptr == GATE_STAGE:
                    bp.flush_cache(cache)
                    flushes += 1
                lg, cache = bp.backpack_forward_with_cache(
                    p, cfg, toks[:, t:t + 1], cache, window=128)
                logits.append(lg.float())
        outs[path] = torch.cat(logits, dim=1)
        del cache
    if not flushes or not torch.isfinite(outs["kernel"]).all():
        raise AssertionError(f"staged gate: flushes {flushes}")
    ek, ep = two_x("staged teacher-forced logits", outs["kernel"],
                   outs["plain"], outs["ref"])
    return dict(max_abs_err=ek, plain_bf16_err=ep, flushes=flushes,
                kernel_vs_plain=max_err(outs["kernel"], outs["plain"]))


# ------------------------------------------------------------------ forward

def phase_forward(gen, results):
    from backpacks_flash_attn_tpu_torch.config import backpack_small
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    from backpacks_flash_attn_tpu_torch.ops import _build

    cfg = backpack_small(vocab_size=50257)
    params = bp.init_backpack(cfg, gen, dtype=torch.bfloat16)
    ids = torch.randint(0, cfg.vocab_size, (FWD_BATCH, FWD_LEN), generator=gen,
                        device=DEV)
    bp.backpack_forward(params, cfg, ids)           # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits = bp.backpack_forward(params, cfg, ids)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _build.launch_counts()
    for name in ("flash_attention", "fused_contextualization"):
        if counts[name] <= 0:
            raise AssertionError(f"backpack_forward launched {name} no time")
    with _build.plain_path():
        plain = bp.backpack_forward(params, cfg, ids)
        ref = bp.backpack_forward(_map_tensors(params, lambda t: t.float()), cfg, ids)
    ek, ep = two_x("backpack_forward logits", logits, plain, ref)
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")
    run = dict(phase="forward", shape=[FWD_BATCH, FWD_LEN], seconds=seconds,
               tokens_per_s=FWD_BATCH * FWD_LEN / seconds, launches=counts,
               max_abs_err=ek, plain_bf16_err=ep)
    emit(run)
    results["forward"] = run


# ------------------------------------------------------------------ train

TRAIN_BATCH, TRAIN_LEN, GATE_BATCH, GATE_BATCHES = 32, 512, 8, 5
TRAIN_WARMUP, TRAIN_TIMED, LEARN_STEPS, LEARN_WINDOW = 2, 10, 40, 5
BIGRAM_VOCAB = 4096


def _rel(a, ref):
    a, ref = a.float(), ref.float()
    return ((a - ref).norm() / ref.norm()).item()


@contextlib.contextmanager
def f32_attention():
    """Inside plain_path(): K3's and K4's plain versions compute in f32 on
    the bf16 activations they are handed and round their outputs back to
    bf16, as the kernels do (K7's plain version already accumulates in
    f32). The rest of the model stays in bf16, so this path's error against
    the f32 reference is the part of the bf16 error that the kernel path
    and the plain path share."""
    from backpacks_flash_attn_tpu_torch.ops import backpack_kernels as bk
    from backpacks_flash_attn_tpu_torch.ops import flash_attention as fa

    flash, ctx = fa.flash_attention_ref, bk.contextualization_reference

    def flash32(q, k, v, **kw):
        out = flash(q.float(), k.float(), v.float(), **kw)
        return (out[0].to(q.dtype), out[1]) if isinstance(out, tuple) else out.to(q.dtype)

    def ctx32(q, k, content, scale, return_lse=False):
        out = ctx(q.float(), k.float(), content.float(), scale, return_lse=return_lse)
        return ((out[0].to(content.dtype), out[1]) if return_lse
                else out.to(content.dtype))

    fa.flash_attention_ref, bk.contextualization_reference = flash32, ctx32
    try:
        yield
    finally:
        fa.flash_attention_ref, bk.contextualization_reference = flash, ctx


def _gate_step(params, batch, forward, picks):
    """One training step's per-token losses, global gradient norm, whole
    gradient and chosen gradients on three paths: kernels in bf16, plain in
    bf16, plain in f32 (the reference); and the per-token losses of the
    shared path (bf16, f32_attention()). forward(params, x, key) ->
    logits."""

    from backpacks_flash_attn_tpu_torch.ops import _build
    from backpacks_flash_attn_tpu_torch.ops.cross_entropy import cross_entropy
    from backpacks_flash_attn_tpu_torch.training import train as tl
    from backpacks_flash_attn_tpu_torch.utils import prng

    key = prng.fold_in(prng.PRNGKey(1), 0)
    x, y = batch["input_ids"][:, :-1], batch["input_ids"][:, 1:]
    outs = {}
    for path, dtype in (("kernel", torch.bfloat16), ("plain", torch.bfloat16),
                        ("ref", torch.float32)):
        p = tl.trainable(_map_tensors(params, lambda t: t.to(dtype)))
        ctx = contextlib.nullcontext() if path == "kernel" else _build.plain_path()
        with ctx:
            logits = forward(p, x, key)
            per_token, _ = cross_entropy(logits, y)
            per_token.mean().backward()          # make_loss_fn's loss
        grads = _map_tensors(p, lambda t: t.grad)
        gnorm = torch.sqrt(sum(g.float().square().sum()
                               for _, g in tl.named_leaves(grads)))
        outs[path] = {"loss_per_token": per_token.detach().float(),
                      "grads": grads, "grad_norm": gnorm,
                      **{k: f(grads) for k, f in picks.items()}}
        del p, logits, per_token
    ref_leaves = tl.named_leaves(outs["ref"].pop("grads"))
    for path in ("kernel", "plain"):
        leaves = dict(tl.named_leaves(outs[path].pop("grads")))
        diff = sum((leaves[k].float() - g).square().sum() for k, g in ref_leaves)
        outs[path]["all_grads"] = diff.sqrt() / outs["ref"]["grad_norm"]
    p = _map_tensors(params, lambda t: t.to(torch.bfloat16))
    with torch.no_grad(), _build.plain_path(), f32_attention():
        shared, _ = cross_entropy(forward(p, x, key), y)
    return outs, shared.float()


def _bias_gate(name, draws):
    """Signed errors against the f32 reference, one per draw, on each path:
    the kernel path's mean must be within twice the bf16 plain path's plus
    three standard errors of a mean (pooled over both paths' draws), so that
    a bias several times the rounding noise of a mean fails, and a mean
    that is one draw of that noise does not. With ``shared`` draws (the
    shared path's errors on the same sequences) each path's draws are taken
    against them first: the check then holds the kernel path's own bias to
    the plain path's own, whatever the bias of the bf16 activations both
    share at these weights."""
    k, p = (torch.tensor(draws[path], dtype=torch.float64)
            for path in ("kernel", "plain"))
    row = {"kernel": k.mean().item(), "plain_bf16": p.mean().item(),
           "draws": len(k)}
    own = ""
    if "shared" in draws:
        s = torch.tensor(draws["shared"], dtype=torch.float64)
        k, p = k - s, p - s
        row.update(shared=s.mean().item(), kernel_own=k.mean().item(),
                   plain_own=p.mean().item())
        own = " own"
    se = math.sqrt((k.var().item() + p.var().item()) / 2 / len(k))
    bk, bp = k.mean().item(), p.mean().item()
    bound = 2 * abs(bp) + 3 * se
    row.update(stderr=se, share_of_bound=abs(bk) / bound)
    return row, None if abs(bk) <= bound else (
        f"{name}: kernel{own} bias {bk:.3e} > 2x plain{own} {abs(bp):.3e} "
        f"+ 3 x stderr {se:.3e}")


def gradient_gate(label, params, batches, forward, picks):
    """Over the batches, kernel path (bf16) vs plain path (bf16) against
    the f32 plain reference. On each batch, the relative error of the
    per-token losses, the whole gradient (every leaf as one vector) and the
    gradients `picks` names (wte, the first and last GPT layer's Wqkv, and
    the Backpack's ctx_attn.Wqkv): the kernel's at most 2x the plain
    path's (or 0). Pooled over the batches, the signed error of the loss
    (one draw per sequence: its mean per-token error, nats; each path's own
    part, net of the shared path's) and of the global gradient norm (one
    relative draw per batch), under _bias_gate."""
    errs, failed = [], []
    draws = {"loss_bias": {"kernel": [], "plain": [], "shared": []},
             "grad_norm_bias": {"kernel": [], "plain": []}}
    for batch in batches:
        outs, shared = _gate_step(params, batch, forward, picks)
        ref = outs["ref"]
        row = {}
        for k in outs["kernel"]:
            if k == "grad_norm":
                continue
            if k == "all_grads":
                ek, ep = outs["kernel"][k].item(), outs["plain"][k].item()
            else:
                ek = _rel(outs["kernel"][k], ref[k])
                ep = _rel(outs["plain"][k], ref[k])
            row[k] = {"kernel": ek, "plain_bf16": ep}
            if not (ek == 0.0 or (ep > 0 and ek <= 2 * ep)):
                failed.append(f"{k}: kernel rel. error {ek:.3e} > 2x plain {ep:.3e}")
        for path in ("kernel", "plain"):
            d = outs[path]["loss_per_token"] - ref["loss_per_token"]
            draws["loss_bias"][path] += d.mean(dim=1).tolist()
            draws["grad_norm_bias"][path].append(
                ((outs[path]["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]).item())
        draws["loss_bias"]["shared"] += (shared - ref["loss_per_token"]
                                         ).mean(dim=1).tolist()
        row["loss"] = ref["loss_per_token"].mean().item()
        errs.append(row)
        del outs, ref
    out = {"per_batch": errs}
    for name, d in draws.items():
        out[name], msg = _bias_gate(name, d)
        if name == "grad_norm_bias":
            out[name].update(kernel_draws=d["kernel"], plain_draws=d["plain"])
        if msg:
            failed.append(msg)
    if failed:
        raise AssertionError(f"gradient gate ({label}): "
                             + "; ".join(failed) + f" (all: {out})")
    return out


def _profile_step(step_once):
    """Device ms by kernel over one training step (torch.profiler, kernel
    events only): the largest 15 and every kernel of the port; and the
    step's wall ms under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    return dict(wall_ms_profiled=wall * 1e3,
                device_ms=sum(us for us, _, _ in rows) / 1e3,
                top=[dict(name=k[:80], ms=us / 1e3, calls=c) for us, k, c in rows[:15]],
                # every kernel in an anonymous namespace, however small: the
                # port's (csrc/ keeps them there) and a few of PyTorch's
                port=[dict(name=k[:80], ms=us / 1e3, calls=c) for us, k, c in rows
                      if k.removeprefix("void ").startswith("(anonymous namespace)::")])


def train_run(label, cfg, params, batches, step_fn, check_launches, **meta):
    """len(batches) - 1 steps of step_fn (AdamW, warmup 10, lr 6e-4) from a
    copy of params: the loss and the kernel launches of every step (counts
    reset just before the step, read just after; check_launches(counts)
    returns what is wrong with them, or None), step ms over the steps after
    TRAIN_WARMUP, tokens/s, MFU, peak memory, and one profiled step on the
    last batch."""
    from backpacks_flash_attn_tpu_torch.ops import _build
    from backpacks_flash_attn_tpu_torch.training import callbacks as cb
    from backpacks_flash_attn_tpu_torch.training import train as tl
    from backpacks_flash_attn_tpu_torch.utils import prng

    p = tl.trainable(_map_tensors(params, lambda t: t.clone()))
    state = tl.TrainState(p, tl.make_optimizer(p, lr=6e-4, warmup_steps=10,
                                               total_steps=1000), 0)
    rng = prng.PRNGKey(1)
    n_steps = len(batches) - 1
    losses, launches, times = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(n_steps):
        _build.reset_launches()
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[i], rng)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append(_build.launch_counts())
        losses.append(m["loss"].item())
        if not math.isfinite(losses[-1]):
            raise AssertionError(f"train {label}: non-finite loss at step {i}")
    peak = torch.cuda.max_memory_allocated()
    for i, counts in enumerate(launches):
        msg = check_launches(counts)
        if msg:
            raise AssertionError(f"train {label} step {i}: {msg}")
    prof = _profile_step(lambda: step_fn(state, batches[n_steps], rng))
    timed = times[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_TIMED]
    step_s = statistics.median(timed)
    b, s = batches[0]["input_ids"].shape
    tokens = b * (s - 1)
    flops = cb.flop_count(cfg, state.params, b, s - 1)
    prof["device_idle_share"] = 1 - prof["device_ms"] / (step_s * 1e3)
    out = dict(phase="train", run=label, **meta, shape=[b, s - 1],
               steps=n_steps, step_ms=step_s * 1e3,
               step_ms_timed=[t * 1e3 for t in timed],
               tokens_per_s=tokens / step_s,
               flops_per_step=flops, mfu=flops / step_s / PEAK_BF16_FLOP_PER_S,
               mfu_formula="training/callbacks.flop_count / step_s / 989e12",
               peak_memory_bytes=peak, launches_per_step=launches[0],
               launches=_sum_counts(launches), losses=losses, profile=prof)
    emit(out)
    trained = _map_tensors(state.params, lambda t: t.detach())
    del state, p, batches
    torch.cuda.empty_cache()
    return out, trained


def _lm_batches(pairs):
    """(x, y) arrays of lmd.batches -> {'input_ids': (b, s + 1)} on the card."""
    return [{"input_ids": torch.from_numpy(np.concatenate([x, y[:, -1:]], 1)
                                           ).long().to(DEV)} for x, y in pairs]


def _sum_counts(rows):
    return {k: sum(r[k] for r in rows) for k in rows[0]}


BP_PICKS = {
    "wte": lambda p: p["gpt"]["wte"],
    "gpt.layers[0].Wqkv": lambda p: p["gpt"]["layers"]["Wqkv"]["kernel"][0],
    "gpt.layers[-1].Wqkv": lambda p: p["gpt"]["layers"]["Wqkv"]["kernel"][-1],
    "ctx_attn.Wqkv": lambda p: p["ctx_attn"]["Wqkv"]["kernel"],
}


def phase_train(gen, results):
    from backpacks_flash_attn_tpu_torch.config import backpack_small
    from backpacks_flash_attn_tpu_torch.data import lm_dataset as lmd
    from backpacks_flash_attn_tpu_torch.data.synthetic import bigram_corpus
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    from backpacks_flash_attn_tpu_torch.training import train as tl

    cfg = backpack_small(vocab_size=50257)
    n_tokens = (LEARN_STEPS + 2) * TRAIN_BATCH * (TRAIN_LEN + 1) * 2
    toks, floor = bigram_corpus(n_tokens, vocab_size=BIGRAM_VOCAB,
                                n_successors=4, seed=0)
    ds = lmd.LMDataset(toks, TRAIN_LEN)
    params = bp.init_backpack(cfg, gen, dtype=torch.bfloat16)
    picks = BP_PICKS
    trained = {}
    for label, fused, n in (("train_einsum", False, LEARN_STEPS),
                            ("train_fused", True, TRAIN_WARMUP + TRAIN_TIMED)):
        log(f"train: {label}")
        stream = lmd.batches(ds, TRAIN_BATCH, lmd.SamplerState(seed=0))
        batches = _lm_batches(next(stream)[0] for _ in range(n + 1))

        def check(counts, fused=fused):
            if counts["flash_attention"] != cfg.n_layer or \
                    counts["flash_attention_bwd"] != cfg.n_layer:
                return f"K3/K5 launches {counts}, want {cfg.n_layer} each"
            if fused and counts["fused_contextualization_bwd"] < 1:
                return "K6 never launched"
            return None

        results[label], trained[label] = train_run(
            label, cfg, params, batches, tl.make_train_step(cfg, fused_ctx=fused),
            check, fused_ctx=fused)
    del trained["train_fused"]

    # at the initial weights every logit is ~0 and the loss sits within an
    # f32 ulp of ln(V) on all three paths: take the gate at the weights of
    # run (a)'s last step
    log("train: gradient gate")
    gate_stream = lmd.batches(ds, GATE_BATCH, lmd.SamplerState(seed=1))
    gate_batches = _lm_batches(xy for xy, _ in (next(gate_stream)
                                                for _ in range(GATE_BATCHES)))
    gate = {f"fused_ctx={f}": gradient_gate(
        f"fused_ctx={f}", trained["train_einsum"], gate_batches,
        lambda p, x, key, f=f: bp.backpack_forward(p, cfg, x, train=True, rng=key,
                                                   fused_ctx=f), picks)
            for f in (False, True)}
    emit({"phase": "train", "gradient_gate": gate})
    results["train_gate"] = gate
    del trained
    losses = results["train_einsum"]["losses"]
    first = statistics.mean(losses[:LEARN_WINDOW])
    last = statistics.mean(losses[-LEARN_WINDOW:])
    results["learning_gate"] = dict(first5=first, last5=last, drop=first - last,
                                    entropy_floor=floor)
    emit({"phase": "train", "learning_gate": results["learning_gate"]})
    if not first - last >= 1.0:
        raise AssertionError(f"learning gate: loss fell {first - last:.3f} nats "
                             f"over {LEARN_STEPS} steps, want >= 1")


# ------------------------------------------------------------------ longctx

LONGCTX_SEQLENS, LONGCTX_TOKENS, LONGCTX_REPS = (2048, 4096, 8192), 16384, 5
K9 = ("blocksparse_fwd", "blocksparse_bwd")


def _launched(fn, names):
    """Run fn once with the launch counts reset just before and read just
    after; fail if a kernel of `names` was not launched."""
    from backpacks_flash_attn_tpu_torch.ops import _build
    _build.reset_launches()
    fn()
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    missing = [n for n in names if counts[n] <= 0]
    if missing:
        raise AssertionError(f"{missing} launched no time: {counts}")
    return {n: counts[n] for n in names}


def _timed(fn, reps=LONGCTX_REPS):
    """ms (median of reps, L2 flushed) and the peak device memory (MB)
    while fn runs."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(fn, reps)
    return ms, torch.cuda.max_memory_allocated() / 2 ** 20


def phase_longctx(gen, results):
    """bench_longctx.py on the card: at s = 2048, 4096, 8192 (b = 16384 / s,
    h 12, d 64, bf16) the causal flash forward (K3) and forward + backward
    (K3 + K5), with TFLOP/s on bench_longctx's count (causal half of 2 or 7
    s^2 products), and the block-sparse forward + backward (K9) under the
    band mask; ms, peak memory, and the launches of one call of each."""
    from backpacks_flash_attn_tpu_torch.ops import flash_attention as fa

    bf = torch.bfloat16
    runs, totals = {}, dict.fromkeys(K9, 0)
    for s in LONGCTX_SEQLENS:
        b = LONGCTX_TOKENS // s
        q, k, v, g = (torch.randn(b, s, LONG_H, LONG_D, generator=gen,
                                  device=DEV).to(bf) for _ in range(4))
        ql, kl, vl = (t.requires_grad_() for t in (q.clone(), k.clone(), v.clone()))
        bm, density = band_blockmask(s)
        flops = lambda n_dots: n_dots * 2 * b * LONG_H * s * s * LONG_D * 0.5
        fns = {
            "flash_fwd": (lambda: fa.flash_attention(q, k, v, causal=True),
                          ("flash_attention",), 2),
            "flash_fwd_bwd": (lambda: torch.autograd.grad(
                fa.flash_attention(ql, kl, vl, causal=True), (ql, kl, vl), g),
                ("flash_attention", "flash_attention_bwd"), 7),
            "blocksparse_fwd_bwd": (lambda: torch.autograd.grad(
                fa.flash_blocksparse_attention(ql, kl, vl, bm, causal=True,
                                               block_q=BS_BLOCK, block_k=BS_BLOCK),
                (ql, kl, vl), g), K9, None),
        }
        row = {"batch": b}
        for name, (fn, kernels, n_dots) in fns.items():
            launches = _launched(fn, kernels)
            ms, peak = _timed(fn)
            row[name] = dict(ms=ms, peak_mb=peak, launches=launches)
            if n_dots:
                row[name]["tflops"] = flops(n_dots) / ms / 1e9
            else:
                row[name]["density"] = density
                for n in K9:
                    totals[n] += launches[n]
        emit({"phase": "longctx", "seqlen": s, **row})
        runs[f"s{s}"] = row
        del q, k, v, g, ql, kl, vl
        torch.cuda.empty_cache()
    results["longctx"] = {"runs": runs, "launches": totals}


# ------------------------------------------------------------------ train-8k

LONG_BATCH, LONG_LEN, GPT_GATE_LEN = 2, 8192, 2048
GPT_PICKS = {
    "wte": lambda p: p["wte"],
    "layers[0].Wqkv": lambda p: p["layers"]["Wqkv"]["kernel"][0],
    "layers[-1].Wqkv": lambda p: p["layers"]["Wqkv"]["kernel"][-1],
}


GATE_TRAIN_STEPS, GATE_TRAIN_SEED = TRAIN_WARMUP + TRAIN_TIMED, 8


def gate_weights(cfg, params, steps=GATE_TRAIN_STEPS, seed=GATE_TRAIN_SEED, model="gpt",
                 shape=(1, GPT_GATE_LEN)):
    """The weights a gradient gate runs at (train-8k's, xl's and mini's):
    ``params`` (not modified, a ``model`` of cfg) trained ``steps`` AdamW
    steps (the timed run's optimizer) at the gate's own ``shape`` (1 x
    GPT_GATE_LEN for the GPTs), dropout on, on the plain path under
    torch.use_deterministic_algorithms, on random tokens from a generator
    of their own seeded ``seed`` (so that no phase's draws move): the same
    bits in every run of one tree and one seed. The timed run's weights
    are not: their bits follow the order of K5's dq atomics. At the initial
    weights every logit is ~0 and the gate would hold nothing."""
    from backpacks_flash_attn_tpu_torch.ops import _build
    from backpacks_flash_attn_tpu_torch.training import train as tl
    from backpacks_flash_attn_tpu_torch.utils import prng

    g = torch.Generator(device=DEV).manual_seed(seed)
    batches = [{"input_ids": torch.randint(0, cfg.vocab_size, (shape[0], shape[1] + 1),
                                           generator=g, device=DEV)} for _ in range(steps)]
    p = tl.trainable(_map_tensors(params, lambda t: t.clone()))
    state = tl.TrainState(p, tl.make_optimizer(p, lr=6e-4, warmup_steps=10,
                                               total_steps=1000), 0)
    step = tl.make_train_step(cfg, model=model)
    rng = prng.PRNGKey(1)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with _build.plain_path():
            for batch in batches:
                state, _ = step(state, batch, rng)
    finally:
        torch.use_deterministic_algorithms(was)
    out = _map_tensors(state.params, lambda t: t.detach())
    del state, p
    return out


def phase_train8k(gen, results, cfg, params):
    """gpt3-small with rotary embeddings (the reference's
    gpt3s-flash-rotary-8k) at batch 2 x 8192, bf16 weights, AdamW, dropout
    on, the fused-MLP switch on, no remat: TRAIN_WARMUP + TRAIN_TIMED steps
    (K3, K5 and K7 once a layer each step). Then the gradient gate at
    GATE_BATCHES batches of 1 x 2048 (where the plain path's attention
    fits), at gate_weights(params): reproducible weights, unlike the timed
    run's."""
    from backpacks_flash_attn_tpu_torch.models import gpt
    from backpacks_flash_attn_tpu_torch.ops import dense
    from backpacks_flash_attn_tpu_torch.training import train as tl

    def check(counts):
        bad = {n: counts[n] for n in ("flash_attention", "flash_attention_bwd",
                                      "fused_mlp_fwd") if counts[n] != cfg.n_layer}
        return f"launches {bad}, want {cfg.n_layer} each" if bad else None

    ids = lambda b, s: {"input_ids": torch.randint(
        0, cfg.vocab_size, (b, s + 1), generator=gen, device=DEV)}
    switch = dense._FUSED_MLP
    dense._FUSED_MLP = True
    try:
        log("train-8k")
        batches = [ids(LONG_BATCH, LONG_LEN) for _ in range(TRAIN_WARMUP + TRAIN_TIMED + 1)]
        results["train_8k"], _ = train_run(
            "train_8k", cfg, params, batches, tl.make_train_step(cfg, model="gpt"),
            check, model="gpt3_small(rotary=True)")
        run = results["train_8k"]
        log(f"train-8k: {run['step_ms']:.1f} ms a step, peak memory "
            f"{run['peak_memory_bytes'] / 2 ** 30:.2f} GiB")
        del batches
        log("train-8k: gradient gate")
        gate_batches = [ids(1, GPT_GATE_LEN) for _ in range(GATE_BATCHES)]
        trained = gate_weights(cfg, params)
        gate = gradient_gate(
            "gpt3s rotary 1 x 2048", trained, gate_batches,
            lambda p, x, key: gpt.gpt_lm_forward(p, cfg, x, train=True, rng=key),
            GPT_PICKS)
    finally:
        dense._FUSED_MLP = switch
    gate["weights"] = dict(steps=GATE_TRAIN_STEPS, seed=GATE_TRAIN_SEED,
                           shape=[1, GPT_GATE_LEN], path="plain, deterministic")
    emit({"phase": "train8k", "gradient_gate": gate})
    results["train_8k_gate"] = gate
    del trained
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ gpt-generate

GEN_BATCH, GEN_PROMPT, GEN_TOKENS = 8, 2048, 64


def _gpt_teacher_forced(params, ref_params, cfg, prompt, tokens, label="gpt-generate"):
    """The last prefill position's logits and those of the first
    COMPARE_STEPS decode steps on the same tokens: kernel path (bf16 cache),
    plain path (bf16), f32 plain reference (f32 weights and cache)."""
    from backpacks_flash_attn_tpu_torch.models import gpt
    from backpacks_flash_attn_tpu_torch.ops import _build

    batch, L = prompt.shape[0], prompt.shape[1] + COMPARE_STEPS
    outs = {}
    for path in ("kernel", "plain", "ref"):
        p = ref_params if path == "ref" else params
        dt = torch.float32 if path == "ref" else torch.bfloat16
        ctx = contextlib.nullcontext() if path == "kernel" else _build.plain_path()
        with ctx:
            cache = gpt.init_kv_cache(cfg, batch, L, dt, device=DEV)
            steps = []
            for ids in [prompt] + [tokens[:, i:i + 1] for i in range(COMPARE_STEPS)]:
                hidden, cache = gpt.gpt_forward_with_cache(p, cfg, ids, cache)
                steps.append(gpt.lm_logits(p, cfg, hidden[:, -1:]).float())
        outs[path] = torch.cat(steps, dim=1)
        del cache
    ek, ep = two_x(f"{label} teacher-forced logits", outs["kernel"],
                   outs["plain"], outs["ref"])
    return dict(kernel=ek, plain_bf16=ep,
                kernel_vs_plain=max_err(outs["kernel"], outs["plain"]))


def phase_generate(gen, results, cfg, params):
    """generate_gpt on the rotary gpt3-small: batch 8, a 2048-token prompt,
    64 greedy tokens, bf16 cache; seconds and tokens/s (the prefill timed
    apart), K3 once a layer for the prefill and K1 once a layer a decode
    step; then the teacher-forced gate of the first 8 decode steps."""
    from backpacks_flash_attn_tpu_torch.models import gpt
    from backpacks_flash_attn_tpu_torch.ops import _build
    from backpacks_flash_attn_tpu_torch.utils.generation import generate_gpt

    prompt = torch.randint(0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT),
                           generator=gen, device=DEV)
    L = GEN_PROMPT + GEN_TOKENS
    generate_gpt(params, cfg, prompt[:, :128], 136, device=DEV)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = gpt.init_kv_cache(cfg, GEN_BATCH, L, device=DEV)
    # the prefill that generate_gpt runs: the LM head on the last position
    hidden, _ = gpt.gpt_forward_with_cache(params, cfg, prompt, cache)
    gpt.lm_logits(params, cfg, hidden[:, -1:]).argmax(-1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    del cache
    _build.reset_launches()
    t0 = time.perf_counter()
    out = generate_gpt(params, cfg, prompt, L, device=DEV)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _build.launch_counts()
    steps = GEN_TOKENS - 1
    want = {"flash_attention": cfg.n_layer, "decode_attention": cfg.n_layer * steps}
    if any(counts[n] != w for n, w in want.items()):
        raise AssertionError(f"gpt-generate launches {counts}, want {want}")
    tokens = out.sequences[:, GEN_PROMPT:]
    cache = gpt.init_kv_cache(cfg, GEN_BATCH, L, device=DEV)
    gpt.gpt_forward_with_cache(params, cfg, prompt, cache)

    def decode_steps():
        for i in range(COMPARE_STEPS):
            hidden, _ = gpt.gpt_forward_with_cache(params, cfg, tokens[:, i:i + 1], cache)
            gpt.lm_logits(params, cfg, hidden).argmax(-1)

    profile = _per_step(*_kernel_profile(decode_steps), COMPARE_STEPS, top=8)
    profile["device_idle_share"] = 1 - (profile["device_ms_per_step"]
                                        / profile["wall_ms_per_step_profiled"])
    del cache
    log("gpt-generate: teacher-forced gate")
    gate = _gpt_teacher_forced(params, _map_tensors(params, lambda t: t.float()),
                               cfg, prompt, tokens)
    run = dict(phase="generate", run="gpt_generate", batch=GEN_BATCH,
               prompt=GEN_PROMPT, new_tokens=GEN_TOKENS, seconds=seconds,
               prefill_s=prefill_s, tokens_per_s=GEN_BATCH * GEN_TOKENS / seconds,
               decode_tokens_per_s=GEN_BATCH * steps / (seconds - prefill_s),
               launches=counts, launches_per_decode_step=counts["decode_attention"] / steps,
               profile=profile, teacher_forced=gate)
    emit(run)
    results["gpt_generate"] = run


def phase_gpt(gen, results, phases):
    """The rotary gpt3-small of the train-8k and gpt-generate runs, at full
    width and depth (12 layers, 768, 12 heads, vocab 50257 padded to
    50264), bf16 weights from the seeded generator."""
    from backpacks_flash_attn_tpu_torch.config import gpt3_small
    from backpacks_flash_attn_tpu_torch.models import gpt

    cfg = gpt3_small(rotary=True, vocab_size=50257)
    params = gpt.init_gpt(cfg, gen, dtype=torch.bfloat16, device=DEV)
    if "train8k" in phases:
        phase_train8k(gen, results, cfg, params)
    if "generate" in phases:
        log("gpt-generate")
        with torch.inference_mode():
            phase_generate(gen, results, cfg, params)


# ------------------------------------------------------------------ decode kernels

# bench_int4_kernels.py's shapes, backpack-small's batch-128 decode: the GPT
# KV rows (E = 128 x 12 heads, dk = dv = 64) and the Backpack combine (E =
# 128 x 16 senses, dk 64, dv 768), each at S = 128, 256, 512
DECODE_BATCH, DECODE_SEQLENS = 128, (128, 256, 512)
DECODE_SHAPES = (("gpt_kv", DECODE_BATCH * 12, 64, 64),
                 ("combine", DECODE_BATCH * 16, 64, 768))
DECODE_LONG_S = 16384
# the gathered form's, the selector's and blockdiag's case past the
# warp-a-row kernels' S cap (a row's S scores in shared memory, S ~58,000),
# from a generator of its own
DECODE_PAST_CAP_S, DECODE_PAST_CAP_SEED = 65536, 17
# gpt-generate's decode: E = batch 8 x 12 heads over the 2048 + 64 cache
GEN_ROWS, GEN_WIDTH = GEN_BATCH * 12, GEN_PROMPT + GEN_TOKENS
# positions each form reads: the gathered form and the direct K8 entries
# skip an empty row (0 out); K1, the selector and blockdiag attend uniformly
# over the whole width there
UNIFORM_EMPTY = ("decode_attention", "decode_attention_selector",
                 "decode_attention_blockdiag")


def _positions(name, lens, s):
    n = lens.clamp(0, s)
    if name in UNIFORM_EMPTY:
        n = torch.where(lens <= 0, s, n)
    return int(n.sum().item())


def _dequantized(kd, vd):
    """SDPA's operands from a dequantized cache: kd (E, dk, S), vd (E, S,
    dv) -> bf16 (1, E, S, dk), (1, E, S, dv)."""
    return kd.transpose(1, 2).to(torch.bfloat16)[None], vd.to(torch.bfloat16)[None]


def _sdpa(q, lk, lv, lens):
    """SDPA over a dequantized cache (_dequantized); an empty row attends
    column 0 (SDPA's all-masked row is NaN)."""
    S = lk.shape[2]
    mask = (torch.arange(S, device=DEV)[None, :] < lens.clamp(min=1)[:, None])
    return lambda: F.scaled_dot_product_attention(
        q[None, :, None, :], lk, lv, attn_mask=mask[None, :, None, :],
        scale=1.0)[0, :, 0]


def _k1_form_cases(label, q, kt, ks, v, vs, lens, library, forms, device_times=False):
    """Gated cases of K1 and its redesigns over one cache (kt (E, dk, S), v
    (E, S, dv), (E, S) scales or None): forms are (name, call label, entry,
    plain, keywords, values); ``device_times`` adds profiler device and host
    times."""
    e, dk = q.shape
    s, dv = v.shape[1], v.shape[2]
    kvb = kt.element_size()
    cases = []
    for name, form, fn, plain, kw, vals in forms:
        n = _positions(name, lens, s)
        args = (q, kt, ks, vals, vs, lens)
        ref_args = (q.float(), kt, ks, vals, vs, lens)
        cases.append((name, f"{label}{form}", dict(
            gate=name,
            kernel=lambda a=args, fn=fn, kw=kw: fn(*a, **kw),
            plain=lambda a=args, fn=plain, kw=kw: fn(*a, **kw),
            ref=lambda a=ref_args, fn=plain, kw=kw: fn(*a, **kw),
            library=library,
            bytes=(q.numel() * 2 + n * (dk + dv) * kvb
                   + (8 * n if ks is not None else 0) + e * dv * 2 + e * 4),
            flops=2 * n * (dk + dv), device_times=True)))
    return cases


def _k1_forms(da, v, vt, names=None):
    """K1 and its redesigns as (name, label suffix, entry, plain version,
    keywords, values): v (E, S, dv), vt its (E, dv, S) copy for the
    selector's native layout; ``names`` keeps some."""
    forms = [
        ("decode_attention", "", da.decode_attention, da.decode_attention_ref, {}, v),
        ("decode_attention_gathered", "", da.decode_attention_gathered,
         da.decode_attention_gathered_ref, {}, v),
        ("decode_attention_selector", " vt=True", da.decode_attention_selector,
         da.decode_attention_selector_ref, {"v_transposed": True}, vt),
        ("decode_attention_selector", " vt=False", da.decode_attention_selector,
         da.decode_attention_selector_ref, {"v_transposed": False}, v),
        ("decode_attention_blockdiag", "", da.decode_attention_blockdiag,
         da.decode_attention_blockdiag_ref, {}, v),
    ]
    return [f for f in forms if names is None or f[0] in names]


def decode_problem_cases(gen, shape, e, dk, dv, s):
    """bench_int4_kernels.make_problem on the card (q x 0.3, keys and values
    N(0, 1) quantized per position to INT8 and to int4, pair-packed, the
    mixed cache's split int8 keys) and its cases under full lengths and
    under ragged ones with row 0 empty: K1, gathered, selector (values
    transposed, and transposed by the wrapper), blockdiag over the INT8
    cache; K8 over the int4 and the mixed caches through JAX's direct
    entries. Library: SDPA over each dequantized cache."""
    from backpacks_flash_attn_tpu_torch.ops import _build
    from backpacks_flash_attn_tpu_torch.ops import decode_attention as da
    from backpacks_flash_attn_tpu_torch.ops import quant

    randn = lambda *sz: torch.randn(*sz, generator=gen, device=DEV)
    q = (randn(e, dk) * 0.3).to(torch.bfloat16)
    k, v = randn(e, dk, s), randn(e, s, dv)
    k8, ks8 = quant.quantize_activations_int8(k, axis=1)
    v8, vs8 = quant.quantize_activations_int8(v, axis=2)
    k4, ks4 = quant.quantize_activations_int4(k, axis=1)
    v4, vs4 = quant.quantize_activations_int4(v, axis=2)
    pairs = lambda sc: sc.reshape(e, s // 2, 2).transpose(1, 2).contiguous()
    kt4, v4p = quant.pack_int4_pairs(k4, axis=2), quant.pack_int4_pairs(v4, axis=1)
    ks2, vs2, ks2b = pairs(ks4[:, 0]), pairs(vs4[:, :, 0]), pairs(ks8[:, 0])
    k8s = torch.stack([k8[:, :, 0::2], k8[:, :, 1::2]], dim=2)
    ks, vs = ks8[:, 0].contiguous(), vs8[:, :, 0].contiguous()
    v8t = v8.transpose(1, 2).contiguous()
    ragged = torch.randint(1, s + 1, (e,), generator=gen, device=DEV,
                           dtype=torch.int32)
    ragged[0] = 0
    full = torch.full((e,), s, dtype=torch.int32, device=DEV)
    caches = {"int8": _dequantized(k8.float() * ks8, v8.float() * vs8),
              "int4": _dequantized(k4.float() * ks4, v4.float() * vs4)}
    caches["mixed"] = (caches["int8"][0], caches["int4"][1])
    del k, v, k4, v4
    cases = []
    for tag, lens in (("full", full), ("ragged", ragged)):
        label = f"{shape}-int8 S={s} {tag}"
        cases += _k1_form_cases(label, q, k8, ks, v8, vs, lens,
                                _sdpa(q, *caches["int8"], lens), _k1_forms(da, v8, v8t))
        cols = int(((lens.clamp(0, s) + 1) // 2).sum().item())
        n = int(lens.clamp(0, s).sum().item())
        for kind, keys, kscale, kbytes in (("int4", kt4, ks2, dk),
                                           ("mixed", k8s, ks2b, 2 * dk)):
            fn = getattr(da, f"decode_attention_{kind}_blockdiag")
            args = (q, keys, kscale, v4p, vs2, lens)
            ref_args = (q.float(), keys, kscale, v4p, vs2, lens)

            def plain(*a, fn=fn):
                with _build.plain_path():
                    return fn(*a)

            cases.append((f"lowbit_decode_{kind}", f"{shape}-{kind} S={s} {tag}", dict(
                gate=f"lowbit_decode_{kind}",
                kernel=lambda a=args, fn=fn: fn(*a),
                plain=lambda a=args, p=plain: p(*a),
                ref=lambda a=ref_args, p=plain: p(*a),
                library=_sdpa(q, *caches[kind], lens),
                bytes=q.numel() * 2 + cols * (kbytes + dv + 16) + e * dv * 2 + e * 4,
                flops=2 * n * (dk + dv), device_times=True)))
    return cases


def decode_long_cases(gen):
    """gpt-generate's decode shape (E = 96, dk = dv = 64, S = 2112, bf16
    cache, lengths 2048-2112), then S = 16384 (lengths 8192-16384): K1 and
    gathered, with profiler device and host times."""
    from backpacks_flash_attn_tpu_torch.ops import decode_attention as da

    bf = torch.bfloat16
    cases = []
    for label, s, lo, names in (
            ("gpt-generate", GEN_WIDTH, GEN_PROMPT, ("decode_attention",
                                                    "decode_attention_gathered")),
            ("long", DECODE_LONG_S, DECODE_LONG_S // 2, ("decode_attention",
                                                         "decode_attention_gathered"))):
        e, d = GEN_ROWS, LONG_D
        q = (torch.randn(e, d, generator=gen, device=DEV) * 0.125).to(bf)
        kt = torch.randn(e, d, s, generator=gen, device=DEV).to(bf)
        v = torch.randn(e, s, d, generator=gen, device=DEV).to(bf)
        lens = torch.randint(lo, s + 1, (e,), generator=gen, device=DEV,
                             dtype=torch.int32)
        cases += _k1_form_cases(f"{label} E={e} S={s} bf16", q, kt, None, v, None,
                                lens, _sdpa(q, *_dequantized(kt, v), lens),
                                _k1_forms(da, v, None, names), device_times=True)
    return cases


def decode_past_cap_cases(names=("decode_attention_gathered", "decode_attention_selector",
                                  "decode_attention_blockdiag")):
    """K1-gathered, K1-selector (values transposed, and transposed by the
    wrapper) and K1-blockdiag (``names`` keeps some of K1's forms) at
    gpt-generate's rows (E = 96, dk = dv = 64) over a bf16 cache of S =
    65,536, lengths 32,768-65,536 with row 0 empty (0 from the gathered
    form, uniform over all S from the others), from a generator of its own
    (DECODE_PAST_CAP_SEED), so that no other case's data move;
    launch-gated, with device and host times."""
    from backpacks_flash_attn_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=DEV).manual_seed(DECODE_PAST_CAP_SEED)
    e, d, s = GEN_ROWS, LONG_D, DECODE_PAST_CAP_S
    bf = torch.bfloat16
    q = (torch.randn(e, d, generator=gen, device=DEV) * 0.125).to(bf)
    kt = torch.randn(e, d, s, generator=gen, device=DEV).to(bf)
    v = torch.randn(e, s, d, generator=gen, device=DEV).to(bf)
    lens = torch.randint(s // 2, s + 1, (e,), generator=gen, device=DEV, dtype=torch.int32)
    lens[0] = 0
    vt = v.transpose(1, 2).contiguous() if "decode_attention_selector" in names else None
    return _k1_form_cases(f"past-cap E={e} S={s} bf16", q, kt, None, v, None, lens,
                          _sdpa(q, *_dequantized(kt, v), lens), _k1_forms(da, v, vt, names),
                          device_times=True)


def k1_serve_cases(gen):
    """K1 at the INT8 serve's own decode lengths: every row at 64 under the
    128 window and at 224 under the 256 window of a 512-column cache
    (window slices), at the GPT rows (E = 128 x 12, dk = dv = 64) and the
    Backpack combine (E = 128 x 16, dv 768); launch-gated, with profiler
    device and host times, SDPA over the dequantized window beside."""
    from backpacks_flash_attn_tpu_torch.ops import decode_attention as da

    cases = []
    for shape, e, dv in (("gpt", BATCH * 12, 64), ("combine", BATCH * 16, 768)):
        q = (torch.randn(e, 64, generator=gen, device=DEV) * 0.125).to(torch.bfloat16)
        kt = torch.randint(-127, 128, (e, 64, MAX_LEN), generator=gen, device=DEV,
                           dtype=torch.int8)
        v = torch.randint(-127, 128, (e, MAX_LEN, dv), generator=gen, device=DEV,
                          dtype=torch.int8)
        ks, vs = torch.rand(2, e, MAX_LEN, generator=gen, device=DEV) * 0.05
        for window, length in ((128, 64), (256, 224)):
            lens = torch.full((e,), length, dtype=torch.int32, device=DEV)
            w = (kt[..., :window], ks[:, :window], v[:, :window], vs[:, :window])
            lk, lv = _dequantized(w[0].float() * w[1][:, None, :], w[2].float() * w[3][..., None])
            cases += _k1_form_cases(
                f"serve-{shape}-int8 E={e} window={window} len={length}", q, w[0], w[1],
                w[2], w[3], lens, _sdpa(q, lk, lv, lens),
                _k1_forms(da, w[2], None, ("decode_attention",)), device_times=True)
    return cases


def _k8_case(kind, label, q, keys, ks, v, vs, lens):
    """A gated K8 case over a pair-packed cache (keys int4 (E, dk, S/2) or
    split int8 (E, dk, 2, S/2), values (E, S/2, dv), (E, 2, S/2) scales):
    ``kind`` int4, mixed or int4_ml, through the dispatcher (K8) or the (m,
    l) form (K8-ml); its plain version under the 2x rule, SDPA over the
    dequantized, interleaved cache beside (an empty row attends column 0
    there), the bytes of the valid packed columns, device and host times.
    Draws no random numbers."""
    from backpacks_flash_attn_tpu_torch.ops import decode_attention as da
    from backpacks_flash_attn_tpu_torch.ops import quant

    e, dk = q.shape
    dv, w2 = v.shape[2], v.shape[1]
    fn, flat = {"int4": (da.decode_attention_int4, da.decode_attention_flat_int4),
                "mixed": (da.decode_attention_mixed, da.decode_attention_flat_mixed),
                "int4_ml": (da.decode_attention_int4_ml,
                            da.decode_attention_flat_int4_ml)}[kind]
    kq = (keys.transpose(2, 3).reshape(e, dk, 2 * w2) if kind == "mixed"
          else quant.unpack_int4_pairs(keys, 2))
    kd = kq.float() * quant.interleave_pair_scales(ks)[:, None, :]
    vd = quant.unpack_int4_pairs(v, 1).float() * quant.interleave_pair_scales(vs)[..., None]
    valid = lens.clamp(0, 2 * w2)
    if kind != "int4_ml":       # the dispatcher's empty row reads every column
        valid = torch.where(lens <= 0, 2 * w2, valid)
    n, cols = int(valid.sum().item()), int(((valid + 1) // 2).sum().item())
    kbytes = dk * (2 if kind == "mixed" else 1)
    args = (q, keys, ks, v, vs, lens)
    return (f"lowbit_decode_{kind}", label, dict(
        gate=f"lowbit_decode_{kind}",
        kernel=lambda a=args: fn(*a),
        plain=lambda a=args: flat(*a),
        ref=lambda a=args: flat(a[0].float(), *a[1:]),
        library=_sdpa(q, *_dequantized(kd, vd), lens),
        bytes=(q.numel() * 2 + cols * (kbytes + dv + 16) + e * dv * 2
               + e * (12 if kind == "int4_ml" else 4)),
        flops=2 * n * (dk + dv), device_times=True))


def k8_serve_cases(gen):
    """K8 and K8-ml at the low-bit serves' own decode lengths: every row at
    64 under the 128 window and at 224 under the 256 window of a 512-column
    cache (window slices of 64 and 128 of its 256 packed columns): K8 int4
    and K8-ml at the GPT rows (E = 128 x 12, dk = dv = 64), K8 mixed at the
    Backpack combine (E = 128 x 16, dv 768); launch-gated, with profiler
    device and host times, SDPA over the dequantized window beside."""
    s2 = MAX_LEN // 2
    cases = []
    for kind, shape, e, dv in (("int4", "gpt", BATCH * 12, 64),
                               ("int4_ml", "gpt", BATCH * 12, 64),
                               ("mixed", "combine", BATCH * 16, 768)):
        q = (torch.randn(e, 64, generator=gen, device=DEV) * 0.125).to(torch.bfloat16)
        kshape = (e, 64, 2, s2) if kind == "mixed" else (e, 64, s2)
        keys = torch.randint(-128, 128, kshape, generator=gen, device=DEV, dtype=torch.int8)
        v = torch.randint(-128, 128, (e, s2, dv), generator=gen, device=DEV, dtype=torch.int8)
        ks, vs = torch.rand(2, e, 2, s2, generator=gen, device=DEV) * 0.05
        if kind == "mixed":
            ks = ks / 16
        for window, length in ((128, 64), (256, 224)):
            w2 = window // 2
            lens = torch.full((e,), length, dtype=torch.int32, device=DEV)
            cases.append(_k8_case(
                kind, f"serve-{shape}-{kind} E={e} window={window} len={length}", q,
                keys[..., :w2], ks[..., :w2], v[:, :w2], vs[..., :w2], lens))
    return cases


def k8_long_cases(gen):
    """K8 int4 past the old kernel's cap (S/2 <= 4096): gpt-generate's rows
    (E = 96, dk = dv = 64) over S = 16384 positions (8192 packed columns),
    lengths 8192-16384 with one odd; launch-gated, with device and host
    times."""
    e, s2 = GEN_ROWS, DECODE_LONG_S // 2
    q = (torch.randn(e, 64, generator=gen, device=DEV) * 0.125).to(torch.bfloat16)
    keys = torch.randint(-128, 128, (e, 64, s2), generator=gen, device=DEV, dtype=torch.int8)
    v = torch.randint(-128, 128, (e, s2, 64), generator=gen, device=DEV, dtype=torch.int8)
    ks, vs = torch.rand(2, e, 2, s2, generator=gen, device=DEV) * 0.05
    lens = torch.randint(DECODE_LONG_S // 2, DECODE_LONG_S + 1, (e,), generator=gen,
                         device=DEV, dtype=torch.int32)
    lens[0] = DECODE_LONG_S - 1
    return [_k8_case("int4", f"long-int4 E={e} S={DECODE_LONG_S}", q, keys, ks, v, vs, lens)]


def phase_decode_kernels(gen, results):
    """bench_int4_kernels.py's comparison on the card, extended: every
    decode kernel form at its six shapes under full and ragged lengths, at
    gpt-generate's decode shape, the gathered form at S = 16384, and the
    gathered form, the selector and blockdiag at S = 65,536. Each
    call's launches are gated (its own kernel once, no other); the launches
    of those gated calls are this path's counts."""
    rows = results.setdefault("kernels", {})
    totals = {}
    problems = [(shape, e, dk, dv, s) for shape, e, dk, dv in DECODE_SHAPES
                for s in DECODE_SEQLENS]
    for shape, e, dk, dv, s in problems:
        log(f"decode kernels: {shape} S={s}")
        cases = decode_problem_cases(gen, shape, e, dk, dv, s)
        _run_gated(cases, rows, totals)
        del cases
        torch.cuda.empty_cache()
    log("decode kernels: gpt-generate's shape, S = 16384")
    _run_gated(decode_long_cases(gen), rows, totals)
    torch.cuda.empty_cache()
    log(f"decode kernels: gathered, selector and blockdiag at S = {DECODE_PAST_CAP_S}")
    _run_gated(decode_past_cap_cases(), rows, totals)
    torch.cuda.empty_cache()
    results["decode_kernels"] = {"launches": totals}
    emit({"phase": "decode_kernels", "launches": totals})


# ------------------------------------------------------------------ head dims

# K3, K5 and K9 at the head dims past 64: backpack-mini's 80 at its training
# shape (32 x 512, 8 heads), gpt3-large's 96 and gpt3-xl's 128 at theirs
# (2 x 2048, 16 heads); f32 (the SIMT loops) at 1 x 512 x 8, and K3's and
# K5's at 80 at the training CLI's own shape (its defaults, 8 x 512, the
# path that runs them); a padded head dim (112, the 128 instance over zero
# columns) and an unaligned bf16 view (the SIMT loop of K3; K5 copies it
# contiguous)
HEAD_DIM_SHAPES = ((80, 32, 512, 8), (96, 2, 2048, 16), (128, 2, 2048, 16))
HEAD_DIM_F32, HEAD_DIM_PADDED, HEAD_DIM_K9 = (1, 512, 8), (112, 2, 1024, 8), (2, 2048, 16)


def _k3_train_case(label, q, k, v, p, seed):
    """K3 (causal, dropout p) against its plain version at q's dtype, with
    launches, device and host times; library = SDPA (its own dropout mask:
    its error is not reported when p > 0). Draws nothing."""
    from backpacks_flash_attn_tpu_torch.ops import flash_attention as fa

    b, s, h, d = q.shape
    scale = d ** -0.5
    kw = dict(causal=True, softmax_scale=scale, dropout_p=p, seed=seed)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    qT, kT, vT = (t.transpose(1, 2) for t in (q, k, v))
    case = dict(
        kernel=lambda: fa._flash_fwd_kernel(q, k, v, scale=scale, seq_lengths=None,
                                            q_offsets=None, causal=True,
                                            dropout_p=p, seed=seed)[0],
        plain=lambda: fa.flash_attention_ref(q, k, v, **kw),
        ref=lambda: fa.flash_attention_ref(q32, k32, v32, **kw),
        library=lambda: F.scaled_dot_product_attention(
            qT, kT, vT, is_causal=True, scale=scale, dropout_p=p).transpose(1, 2),
        bytes=4 * q.numel() * q.element_size() + b * h * s * 4,
        flops=4 * (b * h * s * (s + 1) // 2) * d, gate="flash_attention", device_times=True)
    tag = f"{label} b={b} h={h} s={s} d={d} {str(q.dtype).split('.')[-1]}"
    return ("flash_attention", tag + (f" dropout p={p}" if p else ""),
            _f32_case(case, q.dtype))


def _f32_case(case, dtype):
    """The case dict, given the f32 rule and rate where dtype is f32."""
    if dtype == torch.float32:
        case.update(f32_rtol=1e-5, flop_rate=PEAK_F32_FLOP_PER_S)
    return case


def head_dim_cases(gen):
    """K3, K5 and K9 at head dims 80, 96 and 128 (bf16 on the tensor-core
    bodies, f32 on the SIMT loops), at the padded 112 and over an unaligned
    bf16 view: each launch-gated, under the 2x rule (f32 within 1e-5 of
    the reference's largest magnitude), with device and host times beside
    SDPA's. q, k and v are strided views of one packed tensor as the models
    make them; K9's q pre-scaled, under bench_longctx.py's band mask.
    Drawn after every other phase's data, so that theirs stay as they
    were. Made outside inference mode (the backward yardsticks are
    autograd calls)."""
    from backpacks_flash_attn_tpu_torch.config import backpack_mini
    from backpacks_flash_attn_tpu_torch.training import train_cli

    randn = lambda *s: torch.randn(*s, generator=gen, device=DEV)
    bf, p = torch.bfloat16, 0.1
    seed = (0x5EED1919, 0x0DDBA11)
    cases = []

    def dense(label, b, s, h, d, dt, misalign=0):
        qkv = randn(b, s, 3, h, d + misalign).to(dt)[..., misalign:]
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        dout = randn(b, s, h, d).to(dt)
        cases.append(_k3_train_case(label, q, k, v, p, seed))
        name, tag, case = k5_case(f"{label} b={b} h={h} s={s} d={d} "
                                  f"{str(dt).split('.')[-1]} p={p}", q, k, v, dout, seed, p,
                                  d ** -0.5)
        cases.append((name, tag, _f32_case(case, dt)))

    def sparse(label, b, s, h, d, dt):
        q = (randn(b, s, h, d) * d ** -0.5).to(dt)
        k, v, dout = (randn(b, s, h, d).to(dt) for _ in range(3))
        bm, density = band_blockmask(s)
        tag = f"{label} b={b} h={h} s={s} d={d} {str(dt).split('.')[-1]} density={density:.3f}"
        for name, case in (("blocksparse_fwd", k9_fwd_case(q, k, v, bm, True, BS_BLOCK)),
                           ("blocksparse_bwd", k9_bwd_case(q, k, v, dout, bm, True, BS_BLOCK))):
            case.update(gate=name, device_times=True)
            cases.append((name, tag, _f32_case(case, dt)))

    mini, cli = backpack_mini(), train_cli.RunConfig(corpus="")
    mini_d = mini.n_embd // mini.n_head
    for d, b, s, h in HEAD_DIM_SHAPES:
        dense("heads", b, s, h, d, bf)
        if d != mini_d:
            dense("heads", *HEAD_DIM_F32, d, torch.float32)
        sparse("heads", *HEAD_DIM_K9, d, bf)
        sparse("heads", *HEAD_DIM_F32, d, torch.float32)
    d, b, s, h = HEAD_DIM_PADDED
    dense("padded", b, s, h, d, bf)
    sparse("padded", b, s, h, d, bf)
    dense("unaligned", 8, 512, 8, 80, bf, misalign=1)
    # the xl generation's prefill: 8 prompts of 512, 16 heads of 128, no dropout
    q, k, v = (randn(8, 512, 16, 128).to(bf) for _ in range(3))
    cases.append(_k3_train_case("xl-prefill", q, k, v, 0.0, seed))
    dense("mini-cli", cli.batch_size, cli.seqlen, mini.n_head, mini_d, torch.float32)
    return cases


# ------------------------------------------------------------------ mini

MINI_CLI_STEPS = 3


def _mini_cli(out_dir, vocab):
    """The training CLI as a user runs it (train_cli.main, --model
    backpack-mini, its defaults otherwise: f32, batch 8 x 512, smoke mode's
    3 steps) on a bigram corpus written under out_dir, 2% of it held out
    for the validation perplexity (the default 0.05% of 200k tokens is one
    window short of a batch): the launches of the whole run (K5 once a
    layer a step; K3 for the steps and the validation forwards) and the
    metrics it logged."""
    import io
    from backpacks_flash_attn_tpu_torch.config import backpack_mini
    from backpacks_flash_attn_tpu_torch.data import lm_dataset as lmd
    from backpacks_flash_attn_tpu_torch.data.synthetic import bigram_corpus
    from backpacks_flash_attn_tpu_torch.ops import _build
    from backpacks_flash_attn_tpu_torch.training import train_cli

    n_layer = backpack_mini().n_layer
    toks, _ = bigram_corpus(200_000, vocab_size=vocab, n_successors=4, seed=1)
    work = out_dir / "mini_cli"
    corpus = lmd.save_corpus(toks.astype(np.uint16), str(work), "bigram")
    argv = ["--corpus", corpus, "--model", "backpack-mini", "--mode", "smoke",
            "--val-fraction", "0.02", "--workdir", str(work / "run")]
    _build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        train_cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _build.launch_counts()
    logged = [json.loads(line) for line in (work / "run" / "metrics.jsonl").read_text().splitlines()]
    losses = [row["loss"] for row in logged if "loss" in row]
    ppl = [row["val/ppl"] for row in logged if "val/ppl" in row]
    k3_extra = counts["flash_attention"] - MINI_CLI_STEPS * n_layer
    if (counts["flash_attention_bwd"] != MINI_CLI_STEPS * n_layer or k3_extra <= 0
            or k3_extra % n_layer):
        raise AssertionError(f"mini CLI: launches {counts}, want K5 {MINI_CLI_STEPS * n_layer} "
                             f"and K3 that plus a whole number of validation forwards")
    if not (losses and ppl and all(map(math.isfinite, losses + ppl))):
        raise AssertionError(f"mini CLI: logged {logged}")
    run = dict(phase="mini", run="mini_cli", argv=argv[2:], dtype="float32", seconds=seconds,
               launches={k: n for k, n in counts.items() if n}, losses=losses, val_ppl=ppl[-1])
    emit(run)
    return run


def _mini_forward(params, cfg, gen):
    """backpack_forward (the scoring path, the fused combine) at (8, 512):
    K3 once a layer and K4 once, logits against the plain path under the 2x
    rule."""
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    from backpacks_flash_attn_tpu_torch.ops import _build

    ids = torch.randint(0, cfg.vocab_size, (FWD_BATCH, FWD_LEN), generator=gen, device=DEV)
    bp.backpack_forward(params, cfg, ids)           # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits = bp.backpack_forward(params, cfg, ids)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _build.launch_counts()
    if counts["flash_attention"] != cfg.n_layer or counts["fused_contextualization"] != 1:
        raise AssertionError(f"mini forward: launches {counts}, want K3 {cfg.n_layer}, K4 1")
    with _build.plain_path():
        plain = bp.backpack_forward(params, cfg, ids)
        ref = bp.backpack_forward(_map_tensors(params, lambda t: t.float()), cfg, ids)
    ek, ep = two_x("mini backpack_forward logits", logits, plain, ref)
    run = dict(phase="mini", run="mini_forward", shape=[FWD_BATCH, FWD_LEN], seconds=seconds,
               tokens_per_s=FWD_BATCH * FWD_LEN / seconds,
               launches={k: n for k, n in counts.items() if n}, max_abs_err=ek, plain_bf16_err=ep)
    emit(run)
    return run


def phase_mini(gen, results, out_dir):
    """backpack-mini (8 layers, 640 wide, 8 heads of 80, 16 senses of 40,
    vocab 50257 padded to 50264) at full width and depth, bf16 weights from
    the seeded generator. Training as phase_train at 32 x 512, both combine
    routes (K3 and K5 8 launches a step, the fused route K4 and K6 too),
    the learning gate on the einsum run, the gradient gate (both routes)
    at gate_weights (12 plain deterministic steps at 8 x 512); the training
    CLI at its f32 defaults (the SIMT loops); then serving: a bf16 prefill
    of 128 prompts of 32 (K3 at d 80) and 224 greedy tokens (K1 over
    the GPT layers' dk 80 and the combine), the teacher-forced gate against
    the plain path, a 32-step profile; and backpack_forward at (8, 512)
    (_mini_forward: K3 and K4)."""
    from backpacks_flash_attn_tpu_torch.config import backpack_mini
    from backpacks_flash_attn_tpu_torch.data import lm_dataset as lmd
    from backpacks_flash_attn_tpu_torch.data.synthetic import bigram_corpus
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    from backpacks_flash_attn_tpu_torch.training import train as tl

    cfg = backpack_mini(vocab_size=50257)
    if cfg.n_embd // cfg.n_head != 80:
        raise AssertionError(f"backpack-mini's head dim is {cfg.n_embd // cfg.n_head}")
    n_tokens = (LEARN_STEPS + 2) * TRAIN_BATCH * (TRAIN_LEN + 1) * 2
    toks, floor = bigram_corpus(n_tokens, vocab_size=BIGRAM_VOCAB, n_successors=4, seed=0)
    ds = lmd.LMDataset(toks, TRAIN_LEN)
    params = bp.init_backpack(cfg, gen, dtype=torch.bfloat16)
    for label, fused, n in (("mini_train_einsum", False, LEARN_STEPS),
                            ("mini_train_fused", True, TRAIN_WARMUP + TRAIN_TIMED)):
        log(f"mini: {label}")
        stream = lmd.batches(ds, TRAIN_BATCH, lmd.SamplerState(seed=0))
        batches = _lm_batches(next(stream)[0] for _ in range(n + 1))

        def check(counts, fused=fused):
            bad = {k: counts[k] for k in ("flash_attention", "flash_attention_bwd")
                   if counts[k] != cfg.n_layer}
            if fused:
                bad.update({k: counts[k] for k in ("fused_contextualization",
                                                   "fused_contextualization_bwd")
                            if counts[k] < 1})
            return f"launches {bad}, want K3 and K5 {cfg.n_layer} each" if bad else None

        results[label], _ = train_run(label, cfg, params, batches,
                                      tl.make_train_step(cfg, fused_ctx=fused), check,
                                      model="backpack_mini", fused_ctx=fused)
    losses = results["mini_train_einsum"]["losses"]
    first, last = statistics.mean(losses[:LEARN_WINDOW]), statistics.mean(losses[-LEARN_WINDOW:])
    results["mini_learning_gate"] = dict(first5=first, last5=last, drop=first - last,
                                         entropy_floor=floor)
    emit({"phase": "mini", "learning_gate": results["mini_learning_gate"]})
    if not first - last >= 1.0:
        raise AssertionError(f"mini learning gate: loss fell {first - last:.3f} nats over "
                             f"{LEARN_STEPS} steps, want >= 1")

    log("mini: gradient gate")
    gate_stream = lmd.batches(ds, GATE_BATCH, lmd.SamplerState(seed=1))
    gate_batches = _lm_batches(xy for xy, _ in (next(gate_stream) for _ in range(GATE_BATCHES)))
    trained = gate_weights(cfg, params, model="backpack", shape=(GATE_BATCH, TRAIN_LEN))
    gate = {f"fused_ctx={f}": gradient_gate(
        f"mini fused_ctx={f}", trained, gate_batches,
        lambda p, x, key, f=f: bp.backpack_forward(p, cfg, x, train=True, rng=key, fused_ctx=f),
        BP_PICKS) for f in (False, True)}
    gate["weights"] = dict(steps=GATE_TRAIN_STEPS, seed=GATE_TRAIN_SEED,
                           shape=[GATE_BATCH, TRAIN_LEN], path="plain, deterministic")
    emit({"phase": "mini", "gradient_gate": gate})
    results["mini_train_gate"] = gate
    del trained
    torch.cuda.empty_cache()

    log("mini: the training CLI (f32)")
    results["mini_cli"] = _mini_cli(out_dir, BIGRAM_VOCAB)
    torch.cuda.empty_cache()

    log("mini: forward and serve bf16")
    with torch.inference_mode():
        results["mini_forward"] = _mini_forward(params, cfg, gen)
        prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=DEV)
        run, gen_tokens = serve_run("mini_bf16", params, cfg, "bf16", prompt)
        per_step, prefill = run["launches_per_decode_step"], run["launches_prefill"]
        if (per_step["decode_attention"] != cfg.n_layer + 1
                or prefill["flash_attention"] != cfg.n_layer):
            raise AssertionError(f"mini serve: launches a decode step {per_step}, prefill "
                                 f"{prefill}; want K1 {cfg.n_layer + 1} a step (the GPT "
                                 f"layers and the combine), K3 {cfg.n_layer} a prefill")
        params32 = _map_tensors(params, lambda t: t.float())
        _teacher_forced_gate(run, params, params32, cfg, "f32", prompt, gen_tokens)
        del params32
        _add_profile(run, params, cfg, prompt, SHORT_PROFILE)
    results["mini_serve_bf16"] = run
    del params
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ xl

XL_BATCH, XL_LEN = 2, 2048
XL_GEN_BATCH, XL_GEN_PROMPT, XL_GEN_TOKENS, XL_GEN_SEED = 8, 512, 32, 23


def _xl_generate(params, cfg):
    """generate_gpt at batch 8, a 512-token prompt, 32 greedy tokens (bf16
    cache): K3 once a layer in the prefill (d 128), K1 once a layer a
    decode step (dk 128); then the same under plain_path(): each sequence's
    tokens equal the plain path's up to their first difference, where the
    kernel path's token must lie within twice the plain path's
    teacher-forced error (against the f32 reference) of the plain path's
    top logit on the same prefix (a near-tie of bf16 logits, not a wrong
    token); and the teacher-forced gate of the prefill and the first 8
    decode steps."""
    from backpacks_flash_attn_tpu_torch.ops import _build
    from backpacks_flash_attn_tpu_torch.utils.generation import generate_gpt

    gen = torch.Generator(device=DEV).manual_seed(XL_GEN_SEED)
    prompt = torch.randint(0, cfg.vocab_size, (XL_GEN_BATCH, XL_GEN_PROMPT), generator=gen,
                           device=DEV)
    L = XL_GEN_PROMPT + XL_GEN_TOKENS
    generate_gpt(params, cfg, prompt[:, :64], 72, device=DEV)     # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = generate_gpt(params, cfg, prompt, L, output_scores=True, device=DEV)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _build.launch_counts()
    steps = XL_GEN_TOKENS - 1
    want = {"flash_attention": cfg.n_layer, "decode_attention": cfg.n_layer * steps}
    if any(counts[n] != w for n, w in want.items()):
        raise AssertionError(f"xl generate launches {counts}, want {want}")
    with _build.plain_path():
        plain = generate_gpt(params, cfg, prompt, L, output_scores=True, device=DEV)
    tokens = out.sequences[:, XL_GEN_PROMPT:]
    gate = _gpt_teacher_forced(params, _map_tensors(params, lambda t: t.float()), cfg, prompt,
                               tokens, label="xl generate")
    tol = 2 * gate["plain_bf16"]
    same = tokens == plain.sequences[:, XL_GEN_PROMPT:]
    gaps = []
    for i in range(XL_GEN_BATCH):
        if same[i].all():
            continue
        t = int((~same[i]).nonzero()[0])
        row = plain.scores[i, t].float()
        gap = (row.max() - row[tokens[i, t]]).item()
        gaps.append(dict(sequence=i, step=t, gap=gap))
        if gap > tol:
            raise AssertionError(f"xl generate: sequence {i} step {t}: the kernel's token lies "
                                 f"{gap:.3e} below the plain path's top logit, > {tol:.3e}")
    run = dict(phase="xl", run="xl_generate", batch=XL_GEN_BATCH, prompt=XL_GEN_PROMPT,
               new_tokens=XL_GEN_TOKENS, seconds=seconds,
               tokens_per_s=XL_GEN_BATCH * XL_GEN_TOKENS / seconds, launches=counts,
               launches_per_decode_step=counts["decode_attention"] / steps,
               tokens_equal_share=same.float().mean().item(), first_differences=gaps,
               near_tie_tolerance=tol, teacher_forced=gate)
    emit(run)
    return run



def phase_xl(gen, results):
    """gpt3-xl with rotary embeddings (24 layers, 2048 wide, 16 heads of
    128, 64 rotated channels, vocab 50257 padded to 50264) at full width
    and depth, bf16 weights from the seeded generator: training at 2 x
    2048 with AdamW, dropout and the fused MLP (K3, K5 and K7 24 launches a
    step), the gradient gate at full depth on 5 batches of 1 x 2048 at
    gate_weights; then generate_gpt (_xl_generate, its prompts from a
    generator of their own)."""
    from backpacks_flash_attn_tpu_torch.config import gpt3_xl
    from backpacks_flash_attn_tpu_torch.models import gpt
    from backpacks_flash_attn_tpu_torch.ops import dense
    from backpacks_flash_attn_tpu_torch.training import train as tl

    cfg = gpt3_xl(rotary=True, vocab_size=50257)
    if cfg.head_dim != 128 or cfg.rotary_emb_dim != 64:
        raise AssertionError(f"gpt3-xl: head dim {cfg.head_dim}, rotary {cfg.rotary_emb_dim}")
    params = gpt.init_gpt(cfg, gen, dtype=torch.bfloat16, device=DEV)

    def check(counts):
        bad = {n: counts[n] for n in ("flash_attention", "flash_attention_bwd",
                                      "fused_mlp_fwd") if counts[n] != cfg.n_layer}
        return f"launches {bad}, want {cfg.n_layer} each" if bad else None

    ids = lambda b, s: {"input_ids": torch.randint(0, cfg.vocab_size, (b, s + 1),
                                                   generator=gen, device=DEV)}
    switch = dense._FUSED_MLP
    dense._FUSED_MLP = True
    try:
        log("xl: train")
        batches = [ids(XL_BATCH, XL_LEN) for _ in range(TRAIN_WARMUP + TRAIN_TIMED + 1)]
        results["xl_train"], _ = train_run("xl_train", cfg, params, batches,
                                           tl.make_train_step(cfg, model="gpt"), check,
                                           model="gpt3_xl(rotary=True)")
        del batches
        torch.cuda.empty_cache()
        log("xl: gradient gate")
        gate_batches = [ids(1, GPT_GATE_LEN) for _ in range(GATE_BATCHES)]
        trained = gate_weights(cfg, params)
        gate = gradient_gate(
            "gpt3-xl rotary 1 x 2048", trained, gate_batches,
            lambda p, x, key: gpt.gpt_lm_forward(p, cfg, x, train=True, rng=key), GPT_PICKS)
    finally:
        dense._FUSED_MLP = switch
    gate["weights"] = dict(steps=GATE_TRAIN_STEPS, seed=GATE_TRAIN_SEED,
                           shape=[1, GPT_GATE_LEN], path="plain, deterministic",
                           layers=cfg.n_layer)
    emit({"phase": "xl", "gradient_gate": gate})
    results["xl_train_gate"] = gate
    del trained, gate_batches
    torch.cuda.empty_cache()
    log("xl: generate")
    with torch.inference_mode():
        results["xl_generate"] = _xl_generate(params, cfg)
    del params
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ intervene

IV_BATCH, IV_PROMPT, IV_STEPS, IV_WORDS, IV_STRENGTH = 8, 32, 8, 8, 2
IV_CONTROL = IV_NEGATIVE = 64          # of ENGINE_REQUESTS; the rest plain
IV_EXP_PROMPTS, IV_EXP_TOKENS, IV_GB_PROMPTS, IV_GB_LEN = 8, 32, 4, 16
IV_GB_ITERS, IV_GB_SENSE = 10, 10


def _exact_launches(what, counts, want):
    """The launches of one call: exactly ``want`` (name -> n), no other."""
    got = {k: n for k, n in counts.items() if n}
    if got != {k: n for k, n in want.items() if n}:
        raise AssertionError(f"{what}: launches {got}, want {want}")
    return got


def intervene_gate(label, params, ref_params, cfg, cache_dtype, ref_cache_dtype,
                   prompt, tables, gemm_launches):
    """weighted_decode_step and negative_decode_step teacher-forced over a
    prefill of ``prompt`` and IV_STEPS decode steps on the kernel path's
    greedy tokens: kernel path, plain path and the f32 plain reference
    (ref_params over a ref_cache_dtype cache) on the same tokens, the 2x
    rule on every step's logits; each kernel-path call launch-gated (K3
    once per GPT layer in the prefill, K1 once per layer and once for the
    combine a decode step, K2 ``gemm_launches`` a call)."""
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    from backpacks_flash_attn_tpu_torch.models import interventions as iv
    from backpacks_flash_attn_tpu_torch.ops import _build

    out = {}
    for mode, (table, ann) in tables.items():
        if mode == "weighted":
            step = lambda *a: iv.weighted_decode_step(            # noqa: E731
                *a, anneal=True, annealing_scale=ann)
        else:
            step = lambda *a: iv.negative_decode_step(            # noqa: E731
                *a, anneal=False, annealing_scale=ann)
        runs = {}
        for path in ("kernel", "plain", "ref"):
            ref = path == "ref"
            cache = bp.init_backpack_cache(cfg, IV_BATCH, MAX_LEN,
                                           ref_cache_dtype if ref else cache_dtype)
            state = (iv.init_weighted_decode_state(
                         cfg, IV_BATCH, MAX_LEN,
                         torch.float32 if ref else torch.bfloat16)
                     if mode == "weighted" else
                     iv.init_negative_decode_state(cfg, IV_BATCH, MAX_LEN))
            runs[path] = [ref_params if ref else params, cache, state]
        errs = {"kernel": 0.0, "plain": 0.0, "kernel_vs_plain": 0.0}
        ids, launches = prompt, []
        for i in range(IV_STEPS + 1):
            outs = {}
            for path, run in runs.items():
                _build.reset_launches()
                with (contextlib.nullcontext() if path == "kernel"
                      else _build.plain_path()):
                    logits, run[1], run[2] = step(run[0], cfg, ids, run[1],
                                                  run[2], table)
                torch.cuda.synchronize()
                if path == "kernel":
                    want = ({"flash_attention": cfg.n_layer} if i == 0 else
                            {"decode_attention": cfg.n_layer + 1})
                    launches.append(_exact_launches(
                        f"{label} {mode} step {i}", _build.launch_counts(),
                        {**want, "quant_matmul": gemm_launches}))
                outs[path] = logits.float()
            if not torch.isfinite(outs["kernel"]).all():
                raise AssertionError(f"{label} {mode}: non-finite logits")
            for path in ("kernel", "plain"):
                errs[path] = max(errs[path], max_err(outs[path], outs["ref"]))
            errs["kernel_vs_plain"] = max(errs["kernel_vs_plain"],
                                          max_err(outs["kernel"], outs["plain"]))
            ids = outs["kernel"][:, -1].argmax(-1)[:, None]
        if not (errs["plain"] > 0 and errs["kernel"] <= 2 * errs["plain"]):
            raise AssertionError(f"{label} {mode}: kernel error {errs['kernel']:.3e} "
                                 f"> 2x plain {errs['plain']:.3e}")
        out[mode] = dict(errs, launches_prefill=launches[0],
                         launches_decode_step=launches[1])
        emit({"phase": "intervene", "gate": label, "mode": mode, **out[mode]})
        del runs
        torch.cuda.empty_cache()
    return out


def intervene_forwards(params, cfg, ids, table, ann, edit):
    """weighted_forward and replaced_word_forward through K3 and K4 (the
    launches of each call gated: K3 once per GPT layer, K4 once) against the
    plain path under the 2x rule of the f32 reference."""
    from backpacks_flash_attn_tpu_torch.models import interventions as iv
    from backpacks_flash_attn_tpu_torch.ops import _build

    p32 = _map_tensors(params, lambda t: t.float())
    forwards = {
        "weighted_forward": lambda p: iv.weighted_forward(
            p, cfg, ids, table, annealing_scale=ann),
        "replaced_word_forward": lambda p: iv.replaced_word_forward(
            p, cfg, ids, *edit)}
    out = {}
    for name, fwd in forwards.items():
        fwd(params)                                  # warm-up
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        logits = fwd(params)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _exact_launches(name, _build.launch_counts(), {
            "flash_attention": cfg.n_layer, "fused_contextualization": 1})
        with _build.plain_path():
            plain, ref = fwd(params), fwd(p32)
        ek, ep = two_x(name, logits, plain, ref)
        out[name] = dict(shape=list(ids.shape), seconds=seconds,
                         tokens_per_s=ids.numel() / seconds, launches=launches,
                         max_abs_err=ek, plain_bf16_err=ep)
        emit({"phase": "intervene", "forward": name, **out[name]})
        del logits, plain, ref
    return out


def intervene_engine(qparams, cfg, requests, tables):
    """The engine over INT8 weights and caches at its defaults, 128 slots,
    with control and negative requests beside plain ones: stats, launches
    (K1 13 and its (m, l) form 0 in every step with an intervention slot
    active, the reverse in the others; K2 50 a step and a prefill; K3 12 a
    prefill), peak device memory with the negative state's bytes, a 32-step
    profile (idle and eager shares), and the share of each kind of request
    whose tokens equal the same engine's under plain_path()."""
    from backpacks_flash_attn_tpu_torch.ops import _build

    (ctable, cann), (ntable, nann) = tables["weighted"], tables["negative"]
    kw = dict(control_table=ctable, annealing_scale=cann, negative_table=ntable,
              negative_annealing_scale=nann)
    log("intervene: engine warm-up")
    engine_run(qparams, cfg, [(p, 8, k) for p, _, k in requests[:ENGINE_SLOTS]], **kw)
    torch.cuda.empty_cache()
    log("intervene: engine")
    eng = new_engine(qparams, cfg, **kw)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _build.reset_launches()
    rids = submit_all(eng, requests)
    res = eng.run()
    torch.cuda.synchronize()
    counts, stats = _build.launch_counts(), eng.stats()
    peak = torch.cuda.max_memory_allocated()
    nbytes = eng.nstate.nbytes()
    tokens = [res[r].tokens for r in rids]
    del eng, res
    torch.cuda.empty_cache()
    D, Div = stats["decode_steps"], stats.get("intervention_steps", 0)
    P, G = stats["prefill_dispatches"], gemms(cfg)
    want = {"decode_attention": (cfg.n_layer + 1) * Div,
            "decode_attention_ml": (cfg.n_layer + 1) * (D - Div),
            "quant_matmul": G * (D + P), "flash_attention": cfg.n_layer * P}
    _exact_launches(f"intervene engine ({D} steps, {Div} with an intervention "
                    f"slot, {P} prefills)", counts, want)
    if not Div or stats["completed"] != len(requests):
        raise AssertionError(f"intervene engine: stats {stats}")
    if any(len(t) != r[1] for t, r in zip(tokens, requests)):
        raise AssertionError("intervene engine: a request ended early")
    log("intervene: engine, plain path")
    with _build.plain_path():
        plain_tokens, plain_stats = engine_run(qparams, cfg, requests, **kw)
    torch.cuda.empty_cache()
    kinds = {"plain": lambda k: not k, "control": lambda k: k.get("control"),
             "negative": lambda k: k.get("negative")}
    same = {kind: statistics.mean(a == b for a, b, r in zip(tokens, plain_tokens, requests)
                                  if pick(r[2]))
            for kind, pick in kinds.items()}
    run = dict(phase="intervene", run="engine", stats=stats, launches=counts,
               launches_per_intervention_step={
                   "decode_attention": counts["decode_attention"] / Div,
                   "decode_attention_ml": 0,
                   "quant_matmul": G},
               launches_per_prefill={"flash_attention": cfg.n_layer,
                                     "quant_matmul": G},
               peak_memory_bytes=peak, memory_before_bytes=base,
               negative_state_bytes=nbytes,
               share_equal_to_plain_path=same,
               plain_path_tokens_per_s=plain_stats["tokens_per_s"])
    log("intervene: engine profile")
    run["profile"] = profile_engine(qparams, cfg, requests, **kw)
    emit(run)
    torch.cuda.empty_cache()
    return run


def intervene_experiments(params, cfg, gen, words):
    """The experiment loops end to end at small counts: seconds, shapes,
    finiteness."""
    from backpacks_flash_attn_tpu_torch.eval import control, genderbias, toxicity
    from backpacks_flash_attn_tpu_torch.eval import visualize

    prompts = torch.randint(0, cfg.vocab_size, (IV_EXP_PROMPTS, IV_PROMPT),
                            generator=gen, device=DEV)
    gb = torch.randint(0, cfg.vocab_size, (2 * IV_GB_PROMPTS, IV_GB_LEN),
                       generator=gen, device=DEV).tolist()
    out = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        out[name] = {"seconds": time.perf_counter() - t0}
        return value

    res = timed("run_control_experiment", lambda: control.run_control_experiment(
        params, cfg, words, prompts, max_new_tokens=IV_EXP_TOKENS))
    for strength, entry in res.items():
        g = entry["generations"]
        if g.shape != (IV_EXP_PROMPTS, IV_EXP_TOKENS) or g.min() < 0 \
                or g.max() >= cfg.padded_vocab_size:
            raise AssertionError(f"control strength {strength}: generations {g.shape}")
    out["run_control_experiment"]["strengths"] = sorted(res)
    res = timed("run_toxicity_experiment", lambda: toxicity.run_toxicity_experiment(
        params, cfg, words, prompts, max_new_tokens=IV_EXP_TOKENS, generator=gen,
        scorer=lambda g: {"toxicity": np.zeros(len(g))}))
    for name, entry in res.items():
        if entry["generations"].shape != (IV_EXP_PROMPTS, IV_EXP_TOKENS):
            raise AssertionError(f"toxicity {name}: {entry['generations'].shape}")
    res = timed("run_genderbias_experiment", lambda: genderbias.run_genderbias_experiment(
        params, cfg, gb[:IV_GB_PROMPTS], gb[IV_GB_PROMPTS:], him_id=words[0],
        her_id=words[1], job_ids=[p[3] for p in gb], sense_index=IV_GB_SENSE,
        maxiter=IV_GB_ITERS))
    if not all(math.isfinite(v) for v in res.values()):
        raise AssertionError(f"genderbias: {res}")
    out["run_genderbias_experiment"].update(res)
    loc = timed("localize_prediction", lambda: visualize.localize_prediction(
        params, cfg, prompts[0].tolist(), words[2]))
    if loc.shape != (cfg.num_senses, IV_PROMPT) or not np.isfinite(loc).all():
        raise AssertionError(f"localize_prediction: {loc.shape}")
    emit({"phase": "intervene", "experiments": out})
    return out


def phase_intervene(gen, results):
    """backpack-small at full width and depth (12 layers, 768, 16 senses,
    vocab 50264), seeded random bf16 weights: the teacher-forced gates of
    the weighted and negative decode steps in bf16 and in INT8, the
    intervened full forwards, the engine with control and negative
    requests, and the experiment loops."""
    from backpacks_flash_attn_tpu_torch.config import backpack_small
    from backpacks_flash_attn_tpu_torch.eval import control, toxicity
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    from backpacks_flash_attn_tpu_torch.models import interventions as iv
    from backpacks_flash_attn_tpu_torch.models import quantized as qz

    torch.cuda.empty_cache()
    cfg = backpack_small(vocab_size=50257)
    params = bp.init_backpack(cfg, gen, dtype=torch.bfloat16)
    words = torch.randint(0, cfg.vocab_size, (IV_WORDS,), generator=gen,
                          device=DEV).tolist()
    log("intervene: tables")
    t0 = time.perf_counter()
    tables = {"weighted": control.control_weights(params, cfg, words, IV_STRENGTH),
              "negative": toxicity.toxicity_weights(params, cfg, words)}
    torch.cuda.synchronize()
    run = {"tables_seconds": time.perf_counter() - t0, "words": words,
           "negative_m": iv.negative_m(cfg.padded_vocab_size, 0.02)}
    prompt = torch.randint(0, cfg.vocab_size, (IV_BATCH, IV_PROMPT), generator=gen,
                           device=DEV)
    log("intervene: bf16 gate")
    run["gate_bf16"] = intervene_gate(
        "bf16", params, _map_tensors(params, lambda t: t.float()), cfg,
        torch.bfloat16, torch.float32, prompt, tables, 0)
    log("intervene: full forwards")
    ids = torch.randint(0, cfg.vocab_size, (FWD_BATCH, FWD_LEN), generator=gen,
                        device=DEV)
    edit = iv.mogrify_word(params, cfg, int(ids[0, 7]), int(ids[1, 3]), int(ids[1, 5]))
    run["forwards"] = intervene_forwards(params, cfg, ids, *tables["weighted"], edit)
    del ids
    log("intervene: experiments")
    run["experiments"] = intervene_experiments(params, cfg, gen, words)
    log("intervene: int8 gate (quantizing)")
    qparams = qz.quantize_backpack_params(params, cfg, bits=8)
    q32 = qz.quantize_backpack_params(params, cfg, bits=8, act_dtype=torch.float32)
    del params
    torch.cuda.empty_cache()
    run["gate_int8"] = intervene_gate("int8", qparams, q32, cfg, torch.int8,
                                      torch.int8, prompt, tables, gemms(cfg))
    del q32
    torch.cuda.empty_cache()
    requests = engine_requests(cfg, gen)
    order = torch.randperm(len(requests), generator=gen, device=DEV).tolist()
    modes = {i: {"control": True} for i in order[:IV_CONTROL]}
    modes.update({i: {"negative": True} for i in order[IV_CONTROL:IV_CONTROL + IV_NEGATIVE]})
    requests = [(p, n, modes.get(i, {})) for i, (p, n) in enumerate(requests)]
    run["engine"] = intervene_engine(qparams, cfg, requests, tables)
    results["intervene"] = run
    del qparams
    torch.cuda.empty_cache()


def _run_gated(cases, rows, totals):
    for row in phase_kernels(cases, rows):
        for name, n in row["launches"].items():
            totals[name] = totals.get(name, 0) + n


# ------------------------------------------------------------------ main

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="device,build,kernels,serve,engine,forward,train,"
                            "longctx,train8k,generate,decode_kernels,mini,xl,"
                            "intervene")
    ap.add_argument("--out", type=Path, default=Path("build/chip_smoke"))
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(2)
    from backpacks_flash_attn_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    results = {"device": name, "nvidia_smi": smi}

    log("build")
    seconds = _build.build_all()
    emit({"phase": "build", "seconds": seconds,
          "kernels": sorted(_build.KERNELS)})
    args.out.mkdir(parents=True, exist_ok=True)
    reports = {k.source: k.build_log for k in _build.KERNELS.values()}
    (args.out / "ptxas.txt").write_text("\n".join(
        f"== {src}\n{text}" for src, text in reports.items()))
    results["build_s"] = seconds

    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        if "kernels" in phases:
            log("kernels")
            phase_kernels(kernel_cases(gen), results.setdefault("kernels", {}))
        if "serve" in phases:
            phase_serve(gen, results)
        if "engine" in phases:
            phase_engine(gen, results)
        if "forward" in phases:
            log("forward")
            phase_forward(gen, results)
    if "kernels" in phases:
        log("kernels: training shapes")
        with torch.no_grad():
            phase_kernels(train_kernel_cases(gen), results.setdefault("kernels", {}))
        torch.cuda.empty_cache()
        log("kernels: long context")
        with torch.no_grad():
            phase_kernels(longctx_kernel_cases(gen), results["kernels"])
        torch.cuda.empty_cache()
    if "train" in phases:
        phase_train(gen, results)
    if "longctx" in phases:
        log("longctx")
        phase_longctx(gen, results)
    if "train8k" in phases or "generate" in phases:
        phase_gpt(gen, results, phases)
    if "kernels" in phases:
        log("kernels: K7 at gpt3-large's widths")
        with torch.no_grad():
            phase_kernels(wide_mlp_cases(gen), results["kernels"])
    if "decode_kernels" in phases:
        with torch.inference_mode():
            phase_decode_kernels(gen, results)
    if "kernels" in phases:
        log("kernels: K3 at train-8k's sequence")
        torch.cuda.empty_cache()
        with torch.no_grad():
            phase_kernels(long_flash_cases(gen), results["kernels"])
        torch.cuda.empty_cache()
        log("kernels: K7 over a ragged token count")
        with torch.no_grad():
            phase_kernels(ragged_mlp_cases(gen), results["kernels"])
        torch.cuda.empty_cache()
        log("kernels: K2 at ctx_attn's shape and with a bias; K2 a decode step")
        with torch.inference_mode():
            phase_kernels(k2_extra_cases(gen), results["kernels"])
        k2_decode_step(results)
        log("kernels: K5 at train-8k's shape")
        torch.cuda.empty_cache()
        with torch.no_grad():
            phase_kernels(long_flash_bwd_cases(gen), results["kernels"])
        torch.cuda.empty_cache()
        log("kernels: K4 at backpack-mini's widths")
        with torch.inference_mode():
            phase_kernels(k4_mini_cases(gen), results["kernels"])
        log("kernels: K6 at backpack-mini's widths")
        with torch.no_grad():
            phase_kernels(k6_mini_cases(gen), results["kernels"])
        log("kernels: K1 at the INT8 serve's decode lengths")
        torch.cuda.empty_cache()
        with torch.inference_mode():
            phase_kernels(k1_serve_cases(gen), results["kernels"])
        log("kernels: K8 at the low-bit serves' decode lengths and past S/2 4096")
        torch.cuda.empty_cache()
        with torch.inference_mode():
            phase_kernels(k8_serve_cases(gen) + k8_long_cases(gen), results["kernels"])
        log("kernels: K9 past the old 512-block cap")
        torch.cuda.empty_cache()
        with torch.no_grad():
            phase_kernels(k9_past_cap_cases(gen), results["kernels"])
        log("kernels: K3, K5 and K9 at head dims 80, 96, 128, padded 112 and unaligned")
        torch.cuda.empty_cache()
        with torch.no_grad():
            phase_kernels(head_dim_cases(gen), results["kernels"])
        torch.cuda.empty_cache()
    if "mini" in phases:
        phase_mini(gen, results, args.out)
    if "xl" in phases:
        phase_xl(gen, results)
    if "intervene" in phases:
        with torch.inference_mode():
            phase_intervene(gen, results)

    line = []
    for k in _build.KERNELS.values():
        rows = results.get("kernels", {}).get(k.name, [])
        head = next((r for r in rows if r["case"].startswith(HEADLINE[k.name])), None)
        run = LAUNCH_RUN[k.name]
        launches = results.get(run, {}).get("launches", {}).get(k.name, 0)
        line.append({
            "name": k.name, "route": "cuda",
            "source": f"backpacks_flash_attn_tpu_torch/csrc/{k.source}",
            "replaces": k.replaces, "launches": launches,
            "launches_run": run,
            **{key: head[key] if head else None for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")},
            "case": head["case"] if head else None,
        })
    results["kernel_line"] = line
    (args.out / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
