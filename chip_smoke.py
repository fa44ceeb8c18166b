"""Drive the PyTorch/CUDA port (backpacks_flash_attn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases device,build,kernels,serve,forward] [--out DIR]

Phases, each printing one JSON line:

1. device   the card's name and its nvidia-smi name and power limit.
2. build    compile the hand-written kernels (csrc/*.cu, one nvcc each,
            all at once) and report the seconds.
3. kernels  each kernel at the main path's shapes against its plain PyTorch
            version: the kernel's max error against an f32 plain reference
            must be at most twice the bf16 plain version's. Times (CUDA
            events, median of 25, L2 flushed before each), the bound, and one
            PyTorch library call computing the same function.
4. serve    backpack-small at full width, random weights from a seeded
            generator, 128 requests with 32-token prompts: batched prefill,
            then 224 greedy tokens (window 128 below position 128, 256
            after), in bf16 (bf16 caches) and in INT8 (INT8 weights and
            caches). Tokens/s, launch counts (reset just before, read just
            after each run), and the first 8 teacher-forced steps of the
            kernel path against the plain path under the same 2x rule.
5. forward  backpack_forward at (8, 512) in bf16 through K3 and K4, logits
            against the plain path under the 2x rule.

Then the {"kernels": [...]} line, the nvidia-smi name/power line, and last
{"ok": true, "device": {...}}. Every number also goes to DIR/chip_smoke.json
and the compiler's register/spill report to DIR/ptxas.txt (DIR defaults to
build/chip_smoke). Any failure raises and exits non-zero; with
no CUDA device it exits non-zero before printing any result. TF32 is off
(torch.backends.cuda.matmul.allow_tf32 = False, cudnn.allow_tf32 = False).
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor core
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
        _FLUSH = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    _FLUSH.zero_()


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


def bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, ref):
    if a.shape != ref.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(ref.shape)}")
    return (a.float() - ref.float()).abs().max().item()


def two_x(name, out, plain, ref):
    """The kernel-vs-baseline rule: err(kernel) <= 2 * err(bf16 plain)."""
    ek, ep = max_err(out, ref), max_err(plain, ref)
    if not (ep > 0 and ek <= 2 * ep):
        raise AssertionError(f"{name}: kernel error {ek:.3e} exceeds 2x the "
                             f"bf16 plain error {ep:.3e}")
    return ek, ep


# ------------------------------------------------------------------ kernels

def kernel_cases(gen):
    """(kernel name, case label, run dict) for every main-path shape."""
    from backpacks_flash_attn_tpu_torch.ops import backpack_kernels as bk
    from backpacks_flash_attn_tpu_torch.ops import decode_attention as da
    from backpacks_flash_attn_tpu_torch.ops import flash_attention as fa
    from backpacks_flash_attn_tpu_torch.ops import quant

    dev = DEV
    bf = torch.bfloat16
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    cases = []

    # K1: GPT rows (E = 128*12, dv = 64) and Backpack rows (E = 128*16,
    # dv = 768) over a 512 window, ragged per-row lengths, bf16 and int8
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
                bytes=nbytes, flops=2 * n * (dk + dv))))

    # K2: (128 and 4096) x 768 @ 768 x {2304, 768, 3072, 50304} int8, the
    # fc2 3072 x 768, and one grouped INT4 case
    shapes = [(768, n, 8, None) for n in (2304, 768, 3072, 50264)] + [(3072, 768, 8, None)]
    for M in (128, 4096):
        for K, N, bits, gs in shapes + ([(768, 3072, 4, 128)] if M == 128 else []):
            w = randn(K, N) * 0.02
            qw = quant.quantize_weight(w, bits, gs)
            x = randn(M, K).to(bf)
            wd = quant.dequantize_weight(qw, bf)
            nbytes = (x.numel() * 2 + qw.q.numel() + qw.scale.numel() * 4
                      + M * N * 2)
            cases.append(("quant_matmul", f"M={M} K={K} N={N} int{bits}"
                          + (f" g{gs}" if gs else ""), dict(
                kernel=lambda x=x, qw=qw: quant.quant_matmul(x, qw),
                plain=lambda x=x, qw=qw: quant.quant_matmul_ref(x, qw),
                ref=lambda x=x, qw=qw: quant.quant_matmul_ref(x.float(), qw),
                library=lambda x=x, wd=wd: torch.matmul(x, wd),
                bytes=nbytes, flops=2 * M * K * N)))

    # K3: the cached prefill (128, 12, 32 queries over a 512-column cache,
    # seq_lengths = offset + 32) and the (8, 12, 512) causal forward; the
    # bytes count the key/value columns the masks leave readable
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

    # K4: (8, 512, 16, 48) with d = 768
    b, s, nv, dnv, d = 8, 512, 16, 48, 768
    qk = randn(b, s, 2, nv, dnv).to(bf)
    q, k = qk[:, :, 0], qk[:, :, 1]
    c = randn(b, s, nv, d).to(bf)
    scale = dnv ** -0.5
    pairs = b * nv * s * (s + 1) // 2
    cases.append(("fused_contextualization", f"b={b} s={s} nv={nv} dnv={dnv} d={d}", dict(
        kernel=lambda: bk.fused_contextualization(q, k, c, scale),
        plain=lambda: bk.contextualization_reference(q, k, c, scale),
        ref=lambda: bk.contextualization_reference(q.float(), k.float(), c.float(), scale),
        library=lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), c.transpose(1, 2), is_causal=True,
            scale=scale).sum(dim=1),
        bytes=2 * (2 * q.numel() + c.numel() + b * s * d),
        flops=2 * pairs * (dnv + d))))
    return cases


# the case whose numbers stand for each kernel in the {"kernels"} line: the
# one the INT8 decode step (K1, K2), the INT8 prefill (K3) and the forward
# (K4) run
HEADLINE = {
    "decode_attention": "backpack-int8",
    "quant_matmul": "M=128 K=768 N=50264 int8",
    "flash_attention": "prefill",
    "fused_contextualization": "b=8",
}


def phase_kernels(gen, results):
    from backpacks_flash_attn_tpu_torch.ops import _build
    for name, label, c in kernel_cases(gen):
        out, plain, ref = c["kernel"](), c["plain"](), c["ref"]()
        torch.cuda.synchronize()
        ek, ep = two_x(f"{name} [{label}]", out, plain, ref)
        lib_out = c["library"]()
        row = dict(case=label, max_abs_err=ek, plain_bf16_err=ep,
                   library_err=max_err(lib_out, ref),
                   ms=time_ms(c["kernel"]), plain_ms=time_ms(c["plain"]),
                   library_ms=time_ms(c["library"]))
        row["bound_ms"], row["bound_by"] = bound(c["bytes"], c["flops"])
        results.setdefault(name, []).append(row)
        emit({"phase": "kernels", "kernel": name, **row})
        del out, plain, ref, lib_out
    _build.reset_launches()


# ------------------------------------------------------------------ serve

BATCH, PROMPT, MAX_LEN = 128, 32, 512
SEGMENTS = [(128 - PROMPT, 128), (128, 256)]      # 224 greedy tokens
COMPARE_STEPS = 8
FWD_BATCH, FWD_LEN = 8, 512


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


def serve_once(params, cfg, cache_dtype, prompt, tokens=None):
    """One prefill + 224 greedy tokens on a fresh cache: (prefill s,
    decode s); the generated tokens are appended to `tokens`."""
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    cache = bp.init_backpack_cache(cfg, BATCH, MAX_LEN, cache_dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = bp.backpack_forward_with_cache(params, cfg, prompt, cache)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    first = logits[:, -1].argmax(-1)[:, None]
    if tokens is not None:
        tokens.append(first)
    decode(params, cfg, cache, first, SEGMENTS, tokens)
    torch.cuda.synchronize()
    return t1 - t0, time.perf_counter() - t1


def serve_run(label, params, cfg, cache_dtype, prompt):
    """The main path, SERVE_PASSES times after a warm-up: returns the run's
    record (median prefill/decode times, tokens/s, the launch counts of
    the first pass alone) and the first pass's tokens."""
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    from backpacks_flash_attn_tpu_torch.ops import _build

    # warm-up on a throwaway cache (allocator, cuBLAS heuristics)
    cache = bp.init_backpack_cache(cfg, BATCH, MAX_LEN, cache_dtype)
    logits, cache = bp.backpack_forward_with_cache(params, cfg, prompt, cache)
    decode(params, cfg, cache, logits[:, -1].argmax(-1)[:, None], [(4, 128)])
    del cache

    tokens = []
    _build.reset_launches()
    times = [serve_once(params, cfg, cache_dtype, prompt, tokens)]
    counts = _build.launch_counts()
    times += [serve_once(params, cfg, cache_dtype, prompt)
              for _ in range(SERVE_PASSES - 1)]
    n_tokens = BATCH * sum(n for n, _ in SEGMENTS)
    decode_s = statistics.median(t for _, t in times)
    out = dict(phase="serve", run=label,
               prefill_s=statistics.median(p for p, _ in times),
               decode_s=decode_s, decode_s_passes=[t for _, t in times],
               decode_tokens=n_tokens, tokens_per_s=n_tokens / decode_s,
               launches=counts)
    emit(out)
    return out, torch.cat(tokens, dim=1)


def profile_decode(params, cfg, cache_dtype, prompt):
    """Device time by kernel over the same decode the serve run times (a
    fresh prefill, then every step of SEGMENTS), with torch.profiler
    (kernel events only)."""
    from torch.profiler import ProfilerActivity, profile

    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    steps = sum(n for n, _ in SEGMENTS)
    cache = bp.init_backpack_cache(cfg, BATCH, MAX_LEN, cache_dtype)
    logits, cache = bp.backpack_forward_with_cache(params, cfg, prompt, cache)
    token = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode(params, cfg, cache, token, SEGMENTS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue            # host ops; their kernels are listed themselves
        us = ev.self_device_time_total
        if us > 0:
            rows.append((us, ev.key, ev.count))
    rows.sort(reverse=True)
    del cache
    return dict(steps=steps,
                wall_ms_per_step_profiled=wall * 1e3 / steps,
                device_ms_per_step=sum(us for us, _, _ in rows) / 1e3 / steps,
                top=[dict(name=k[:80], ms_per_step=us / 1e3 / steps,
                          calls_per_step=c / steps)
                     for us, k, c in rows[:12]])


def teacher_forced(params, ref_params, cfg, cache_dtype, ref_dtype, prompt, gen_tokens):
    """Logits of the first COMPARE_STEPS decode steps (and the prefill) on
    the same tokens: kernel path, plain path, f32 plain reference."""
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    from backpacks_flash_attn_tpu_torch.ops import _build

    caches = {
        "kernel": bp.init_backpack_cache(cfg, BATCH, MAX_LEN, cache_dtype),
        "plain": bp.init_backpack_cache(cfg, BATCH, MAX_LEN, cache_dtype),
        "ref": bp.init_backpack_cache(cfg, BATCH, MAX_LEN, ref_dtype),
    }
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


def phase_serve(gen, results):
    from backpacks_flash_attn_tpu_torch.config import backpack_small
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    from backpacks_flash_attn_tpu_torch.models import quantized as qz

    cfg = backpack_small(vocab_size=50257)
    params = bp.init_backpack(cfg, gen, dtype=torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device=DEV)

    log("serve: bf16")
    run, gen_tokens = serve_run("bf16", params, cfg, torch.bfloat16, prompt)
    params32 = _map_tensors(params, lambda t: t.float())
    errs = teacher_forced(params, params32, cfg, torch.bfloat16, torch.float32,
                          prompt, gen_tokens)
    del params32
    run["teacher_forced_max_abs_err"] = errs["kernel"]
    run["teacher_forced_plain_bf16_err"] = errs["plain"]
    emit({"phase": "serve", "run": "bf16", "teacher_forced": errs})
    _add_profile(run, params, cfg, torch.bfloat16, prompt)
    results["serve_bf16"] = run

    log("serve: int8 (quantizing)")
    qparams = qz.quantize_backpack_params(params, cfg, bits=8)
    # the f32 reference: the same INT8 codes and scales, f32 activations
    q32 = qz.quantize_backpack_params(params, cfg, bits=8,
                                      act_dtype=torch.float32)
    del params
    torch.cuda.empty_cache()
    run, gen_tokens = serve_run("int8", qparams, cfg, torch.int8, prompt)
    counts = run["launches"]
    for name in ("decode_attention", "quant_matmul", "flash_attention"):
        if counts[name] <= 0:
            raise AssertionError(f"INT8 serve run launched {name} no time")
    errs = teacher_forced(qparams, q32, cfg, torch.int8, torch.int8, prompt, gen_tokens)
    run["teacher_forced_max_abs_err"] = errs["kernel"]
    run["teacher_forced_plain_bf16_err"] = errs["plain"]
    emit({"phase": "serve", "run": "int8", "teacher_forced": errs})
    _add_profile(run, qparams, cfg, torch.int8, prompt)
    results["serve_int8"] = run
    return cfg


def _add_profile(run, params, cfg, cache_dtype, prompt):
    """Idle share = 1 - device ms / wall ms per step, both over the same
    segments: against the unprofiled timed run (the headline) and against
    the profiled run itself (which carries the profiler's host overhead).
    No clamp: a negative share would expose an inconsistent reading."""
    prof = profile_decode(params, cfg, cache_dtype, prompt)
    step_ms = run["decode_s"] * 1e3 / sum(n for n, _ in SEGMENTS)
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


# ------------------------------------------------------------------ main

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="device,build,kernels,serve,forward")
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
    (args.out / "ptxas.txt").write_text("\n".join(
        f"== {k.source}\n{k.build_log}" for k in _build.KERNELS.values()))
    results["build_s"] = seconds

    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        if "kernels" in phases:
            log("kernels")
            phase_kernels(gen, results.setdefault("kernels", {}))
        if "serve" in phases:
            phase_serve(gen, results)
        if "forward" in phases:
            log("forward")
            phase_forward(gen, results)

    line = []
    for k in _build.KERNELS.values():
        rows = results.get("kernels", {}).get(k.name, [])
        head = next((r for r in rows if r["case"].startswith(HEADLINE[k.name])), None)
        run = "forward" if k.name == "fused_contextualization" else "serve_int8"
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
