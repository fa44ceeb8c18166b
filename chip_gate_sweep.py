"""The gradient gates of ``chip_smoke.py`` over many initial weights.

    python3 chip_gate_sweep.py [--model backpack|gpt] [--seeds 0-9] [--repeat N] [--out DIR]

``--model gpt``: train-8k's gate. For each seed: rotary gpt3-small's bf16
weights from a CUDA generator seeded with it, ``chip_smoke.gate_weights``
(12 AdamW steps at 1 x 2048 on the plain path, deterministic), then
chip_smoke's gradient gate (fused MLP on) on 5 batches of 1 x 2048 drawn
from the same generator; ``--repeat`` runs each seed that many times, so
that a reading can be seen to repeat. One JSON line a run.

The default, ``--model backpack``, is backpack-small's gate:

For each seed: backpack-small's bf16 weights from a CUDA generator seeded
with it, the 40 AdamW steps of chip_smoke's train-einsum run (32 x 512,
the bigram corpus), then chip_smoke's gradient gate on its 5 batches of 8 x
512 for both combine routes (fused_ctx False and True), every reading
recorded whether the gate passes or not. Beside the gate, forward-only
per-token losses on the same batches, dropout keys and weights under
hybrid paths that bisect the loss bias by kernel:

  ideal       every attention op (K3's and K4's plain versions) computed in
              f32 on the bf16 activations it is handed, its output rounded
              to bf16 as the kernel's is; the rest of the model as in bf16
  k3_ideal    K3 replaced by that f32 op, K4 (fused route) the kernel
  k4_ideal    K4 replaced by that f32 op, K3 the kernel

Each path's loss bias against the f32 reference, and against ``ideal``
(its own part), pooled per sequence as the gate pools. One JSON line per
seed and route on stdout; everything also to DIR/gate_sweep.json.
"""

import argparse
import json
import math
from pathlib import Path

import torch

import chip_smoke as cs


def _seeds(text):
    if "-" in text:
        a, b = text.split("-")
        return list(range(int(a), int(b) + 1))
    return [int(s) for s in text.split(",")]


def _ideal_ops(fa, bk, which):
    """Replacements of the kernel launchers (and, for the plain path, the
    plain versions) by the f32 computation on the same bf16 inputs."""
    ref_flash, ref_ctx = fa.flash_attention_ref, bk.contextualization_reference

    def flash_fwd(q, k, v, *, causal, scale, seq_lengths, q_offsets, dropout_p, seed, **_):
        out, lse = ref_flash(q.float(), k.float(), v.float(), causal=causal,
                             softmax_scale=scale, seq_lengths=seq_lengths,
                             q_offsets=q_offsets, dropout_p=dropout_p, seed=seed,
                             return_lse=True)
        return out.to(q.dtype), lse

    def ctx_fwd(q, k, content, scale):
        out, lse = ref_ctx(q.float(), k.float(), content.float(), scale,
                           return_lse=True)
        return out.to(content.dtype), lse

    patches = []
    if which in ("ideal", "k3_ideal"):
        patches.append((fa, "_flash_fwd_kernel", flash_fwd))
    if which in ("ideal", "k4_ideal"):
        patches.append((bk, "_fwd_kernel", ctx_fwd))
    return patches


def _forward_losses(params, batch, forward, which, dtype=torch.bfloat16):
    from backpacks_flash_attn_tpu_torch.ops import backpack_kernels as bk
    from backpacks_flash_attn_tpu_torch.ops import flash_attention as fa
    from backpacks_flash_attn_tpu_torch.ops.cross_entropy import cross_entropy
    from backpacks_flash_attn_tpu_torch.utils import prng

    key = prng.fold_in(prng.PRNGKey(1), 0)
    x, y = batch["input_ids"][:, :-1], batch["input_ids"][:, 1:]
    p = cs._map_tensors(params, lambda t: t.to(dtype))
    patches = _ideal_ops(fa, bk, which)
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    try:
        for m, n, f in patches:
            setattr(m, n, f)
        with torch.no_grad():
            per_token, _ = cross_entropy(forward(p, x, key), y)
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    return per_token.float()


def _bias(draws):
    t = torch.tensor(draws, dtype=torch.float64)
    return {"mean": t.mean().item(), "stderr": t.std().item() / math.sqrt(len(t))}


def sweep_seed(seed, cfg, ds, gate_batches, picks):
    from backpacks_flash_attn_tpu_torch.models import backpack as bp
    from backpacks_flash_attn_tpu_torch.data import lm_dataset as lmd
    from backpacks_flash_attn_tpu_torch.ops import _build
    from backpacks_flash_attn_tpu_torch.training import train as tl
    from backpacks_flash_attn_tpu_torch.utils import prng

    gen = torch.Generator(device=cs.DEV).manual_seed(seed)
    params = bp.init_backpack(cfg, gen, dtype=torch.bfloat16, device=cs.DEV)
    stream = lmd.batches(ds, cs.TRAIN_BATCH, lmd.SamplerState(seed=0))
    batches = cs._lm_batches(next(stream)[0] for _ in range(cs.LEARN_STEPS))
    p = tl.trainable(cs._map_tensors(params, lambda t: t.clone()))
    state = tl.TrainState(p, tl.make_optimizer(p, lr=6e-4, warmup_steps=10,
                                               total_steps=1000), 0)
    step = tl.make_train_step(cfg, fused_ctx=False)
    rng = prng.PRNGKey(1)
    for b in batches:
        state, m = step(state, b, rng)
    last_loss = m["loss"].item()
    trained = cs._map_tensors(state.params, lambda t: t.detach())
    del state, p, batches, params
    torch.cuda.empty_cache()

    rows = []
    for fused in (False, True):
        fwd = (lambda q, x, key, f=fused: bp.backpack_forward(
            q, cfg, x, train=True, rng=key, fused_ctx=f))
        try:
            gate, failure = cs.gradient_gate(f"fused_ctx={fused}", trained,
                                             gate_batches, fwd, picks), None
        except AssertionError as exc:
            gate, failure = None, str(exc)
        draws = {k: [] for k in ("kernel", "plain", "ref", "ideal", "k3_ideal",
                                 "k4_ideal")}
        for batch in gate_batches:
            for path in draws:
                if path in ("ref", "plain"):
                    with _build.plain_path():
                        lt = _forward_losses(trained, batch, fwd, path,
                                             torch.float32 if path == "ref"
                                             else torch.bfloat16)
                else:
                    lt = _forward_losses(trained, batch, fwd, path)
                draws[path].append(lt)
        per_seq = {k: torch.cat([t.mean(dim=1) for t in v]) for k, v in draws.items()}
        ref = per_seq["ref"]
        biases = {f"{k}-ref": _bias((v - ref).tolist())
                  for k, v in per_seq.items() if k != "ref"}
        biases.update({f"{k}-ideal": _bias((per_seq[k] - per_seq["ideal"]).tolist())
                       for k in ("kernel", "plain", "k3_ideal", "k4_ideal")})
        row = {"seed": seed, "fused_ctx": fused, "trained_last_loss": last_loss,
               "gate": gate, "gate_failure": failure,
               "forward_loss_bias": biases}
        if gate:   # the parent's gate reports no share: its bound, computed
            lb = gate["loss_bias"]
            row["loss_bias_share_of_bound"] = lb.get("share_of_bound", abs(
                lb["kernel"]) / (2 * abs(lb["plain_bf16"]) + 3 * lb["stderr"]))
        cs.emit(row)
        rows.append(row)
    del trained
    torch.cuda.empty_cache()
    return rows


def sweep_gpt_seed(seed, cfg, run):
    """train-8k's gate at the weights gate_weights makes from the seeded
    initial weights; the reading recorded whether the gate passes or not."""
    from backpacks_flash_attn_tpu_torch.models import gpt

    gen = torch.Generator(device=cs.DEV).manual_seed(seed)
    params = gpt.init_gpt(cfg, gen, dtype=torch.bfloat16, device=cs.DEV)
    gate_batches = [{"input_ids": torch.randint(0, cfg.vocab_size, (1, cs.GPT_GATE_LEN + 1),
                                                generator=gen, device=cs.DEV)}
                    for _ in range(cs.GATE_BATCHES)]
    trained = cs.gate_weights(cfg, params)
    del params
    try:
        gate, failure = cs.gradient_gate(
            f"gpt3s rotary seed {seed}", trained, gate_batches,
            lambda p, x, key: gpt.gpt_lm_forward(p, cfg, x, train=True, rng=key),
            cs.GPT_PICKS), None
    except AssertionError as exc:
        gate, failure = None, str(exc)
    del trained
    torch.cuda.empty_cache()
    row = {"model": "gpt", "seed": seed, "run": run, "gate": gate, "gate_failure": failure}
    if gate:
        row["loss_bias_share_of_bound"] = gate["loss_bias"]["share_of_bound"]
        row["grad_norm_bias_share_of_bound"] = gate["grad_norm_bias"]["share_of_bound"]
    cs.emit(row)
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("backpack", "gpt"), default="backpack")
    ap.add_argument("--seeds", default="0-9")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--out", type=Path, default=Path("build/gate_sweep"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_gate_sweep: no CUDA device")
    from backpacks_flash_attn_tpu_torch.config import backpack_small, gpt3_small
    from backpacks_flash_attn_tpu_torch.data import lm_dataset as lmd
    from backpacks_flash_attn_tpu_torch.data.synthetic import bigram_corpus
    from backpacks_flash_attn_tpu_torch.ops import _build, dense

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    cs.emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    _build.build_all()
    if args.model == "gpt":
        cfg = gpt3_small(rotary=True, vocab_size=50257)
        dense._FUSED_MLP = True
        rows = []
        for seed in _seeds(args.seeds):
            for run in range(args.repeat):
                cs.log(f"gate sweep (gpt): seed {seed}, run {run}")
                rows.append(sweep_gpt_seed(seed, cfg, run))
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "gate_sweep_gpt.json").write_text(json.dumps(
            {"nvidia_smi": smi, "rows": rows}, indent=1))
        failed = [(r["seed"], r["run"]) for r in rows if r["gate_failure"]]
        cs.emit({"gate_failures": failed, "runs": len(rows)})
        print(smi, flush=True)
        return
    cfg = backpack_small(vocab_size=50257)
    n_tokens = (cs.LEARN_STEPS + 2) * cs.TRAIN_BATCH * (cs.TRAIN_LEN + 1) * 2
    toks, _ = bigram_corpus(n_tokens, vocab_size=cs.BIGRAM_VOCAB, n_successors=4,
                            seed=0)
    ds = lmd.LMDataset(toks, cs.TRAIN_LEN)
    gate_stream = lmd.batches(ds, cs.GATE_BATCH, lmd.SamplerState(seed=1))
    gate_batches = cs._lm_batches(xy for xy, _ in (next(gate_stream)
                                                   for _ in range(cs.GATE_BATCHES)))
    picks = {
        "wte": lambda p: p["gpt"]["wte"],
        "gpt.layers[0].Wqkv": lambda p: p["gpt"]["layers"]["Wqkv"]["kernel"][0],
        "gpt.layers[-1].Wqkv": lambda p: p["gpt"]["layers"]["Wqkv"]["kernel"][-1],
        "ctx_attn.Wqkv": lambda p: p["ctx_attn"]["Wqkv"]["kernel"],
    }
    rows = []
    for seed in _seeds(args.seeds):
        cs.log(f"gate sweep: seed {seed}")
        rows += sweep_seed(seed, cfg, ds, gate_batches, picks)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "gate_sweep.json").write_text(json.dumps(
        {"nvidia_smi": smi, "rows": rows}, indent=1))
    failed = [(r["seed"], r["fused_ctx"]) for r in rows if r["gate_failure"]]
    cs.emit({"gate_failures": failed, "runs": len(rows)})
    print(smi, flush=True)


if __name__ == "__main__":
    main()
