"""Interactive generation & sense-control REPL.

Port of ``backpacks_flash_attn_tpu/cli.py``: the user entry points of the
reference (training/src/demo_generate.py, interactive.py,
modulate_generate.py) as one CLI, on the card unless ``--device cpu``:

    python -m backpacks_flash_attn_tpu_torch.cli \\
        --checkpoint last.ckpt --model backpack-small \\
        [--vocab vocab.json --merges merges.txt] [--int8] [--temperature 0.8]
        [--top-p 0.95] [--top-k 40] [--device cuda]

``--checkpoint`` takes the port's (or the JAX package's) ``.npz`` through
``training/checkpoint.restore``, or a reference ``.ckpt``/``.pt`` through
``utils/torch_import``. Without tokenizer files, prompts are space-separated
token ids. Commands inside the REPL:

    <prompt>                      generate a continuation
    /upweight <token> <factor>    multiply a token's sense weights
    /edit <tok> <out> <in>        knowledge-edit: project tok's senses
                                  out of <out>'s direction into <in>'s
    /senses <token>               show top vocab per sense
    /reset                        clear interventions
    /quit
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from . import config as config_lib
from .models import backpack as bp
from .models import interventions as iv
from .ops import _build
from .utils import generation, prng
from .utils.weights import to_device

MODELS = {
    "backpack-micro": config_lib.backpack_micro,
    "backpack-mini": config_lib.backpack_mini,
    "backpack-small": config_lib.backpack_small,
    "backpack-test": config_lib.backpack_test,
}


def _load(args):
    """(cfg, params on args.device): the checkpoint's weights in bf16, or
    seeded random ones; INT8 with --int8."""
    cfg = MODELS[args.model]()
    device = _build.resolve_device(args.device)
    if args.checkpoint:
        if args.checkpoint.endswith(".npz"):
            from .training import checkpoint as ckpt_lib
            template = bp.init_backpack(cfg, torch.Generator().manual_seed(0),
                                        dtype=torch.bfloat16, device="cpu")
            params, _, _ = ckpt_lib.restore(args.checkpoint, template)
            params = to_device(params, device)
        else:
            from .utils.torch_import import load_backpack_checkpoint
            params = load_backpack_checkpoint(args.checkpoint, cfg,
                                              dtype=torch.bfloat16,
                                              device=device)
    else:
        print("[no checkpoint: random weights]")
        params = bp.init_backpack(
            cfg, torch.Generator(device=device).manual_seed(args.seed),
            dtype=torch.bfloat16, device=device)
    if args.int8:
        from .models import quantized as qz
        params = qz.quantize_backpack_params(params, cfg, bits=8)
    return cfg, params


def _make_tokenizer(args):
    if args.vocab and args.merges:
        from .utils.fast_tokenizer import FastGPT2Tokenizer
        from .utils.tokenizer import GPT2Tokenizer
        return FastGPT2Tokenizer(
            GPT2Tokenizer.from_files(args.vocab, args.merges))
    return None


class Repl:
    def __init__(self, cfg, params, tokenizer, args):
        self.cfg = cfg
        self.params = params
        self.tok = tokenizer
        self.args = args
        self.device = _build.resolve_device(args.device)
        self.sense_weights: Optional[torch.Tensor] = None
        self.sense_edit = None
        self.rng = prng.PRNGKey(args.seed)

    def encode(self, text: str):
        if self.tok:
            return self.tok(text)["input_ids"]
        return [int(t) for t in text.split()]

    def decode(self, ids) -> str:
        if self.tok:
            return self.tok.decode(ids)
        return " ".join(str(int(i)) for i in ids)

    def token_id(self, word: str) -> int:
        if self.tok:
            return self.tok(" " + word)["input_ids"][0]
        return int(word)

    def generate(self, text: str) -> str:
        ids = torch.tensor([self.encode(text)], dtype=torch.long,
                           device=self.device)
        self.rng, sub = prng.split(self.rng)
        n = self.args.max_new_tokens
        if self.sense_weights is not None:
            # (V, nv) table => per-token weighted decode (control pipeline);
            # its sampler draws from a torch.Generator, seeded from the key
            from .eval.control import generate_weighted
            gen = torch.Generator(device=self.device).manual_seed(
                int(prng.seed_words(sub)[1]))
            out = generate_weighted(self.params, self.cfg, ids,
                                    self.sense_weights, anneal=False,
                                    max_new_tokens=n,
                                    temperature=self.args.temperature,
                                    generator=gen)
            return self.decode(out[0])
        out = generation.generate_backpack(
            self.params, self.cfg, ids, max_length=ids.shape[1] + n,
            temperature=self.args.temperature, top_p=self.args.top_p,
            top_k=self.args.top_k,
            rng=sub if self.args.temperature > 0 else None,
            sense_edit=self.sense_edit, device=self.device)
        return self.decode(out.sequences[0, ids.shape[1]:].tolist())

    def command(self, line: str) -> str:
        parts = line.split()
        if parts[0] == "/quit":
            raise SystemExit(0)
        if parts[0] == "/reset":
            self.sense_weights = None
            self.sense_edit = None
            return "[interventions cleared]"
        if parts[0] == "/upweight":
            tok, factor = self.token_id(parts[1]), float(parts[2])
            w = (np.ones((self.cfg.padded_vocab_size, self.cfg.num_senses),
                         np.float32) if self.sense_weights is None
                 else self.sense_weights.cpu().numpy())
            w[tok] *= factor
            self.sense_weights = torch.from_numpy(w).to(self.device)
            return f"[senses of token {tok} x{factor}]"
        if parts[0] == "/edit":
            t, o, i = (self.token_id(p) for p in parts[1:4])
            self.sense_edit = iv.mogrify_word(self.params, self.cfg, t, o, i)
            return f"[token {t}: projected {o} -> {i}]"
        if parts[0] == "/senses":
            tok = self.token_id(parts[1])
            from .eval.control import top_vocab_per_sense
            vis = top_vocab_per_sense(self.params, self.cfg, tok, k=5)
            lines = []
            for s, d in vis.items():
                tops = (self.decode(d["top_ids"]) if self.tok
                        else str(d["top_ids"]))
                lines.append(f"  sense {s:2d}: {tops}")
            return "\n".join(lines)
        return f"[unknown command {parts[0]}]"

    def run(self):
        print("backpack REPL — /upweight /edit /senses /reset /quit")
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                out = (self.command(line) if line.startswith("/")
                       else self.generate(line))
            except SystemExit:
                return
            except Exception as e:  # keep the REPL alive
                out = f"[error: {type(e).__name__}: {e}]"
            print(out, flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--model", default="backpack-small", choices=sorted(MODELS))
    p.add_argument("--vocab", default=None)
    p.add_argument("--merges", default=None)
    p.add_argument("--int8", action="store_true")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-p", type=float, default=1.0,
                   help="nucleus sampling cutoff (1.0 = off)")
    p.add_argument("--top-k", type=int, default=0,
                   help="top-k sampling cutoff (0 = off)")
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    args = p.parse_args(argv)
    cfg, params = _load(args)
    Repl(cfg, params, _make_tokenizer(args), args).run()


if __name__ == "__main__":
    main()
