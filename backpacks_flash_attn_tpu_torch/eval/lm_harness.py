"""EleutherAI lm-evaluation-harness adapter (LM Evaluation, paper §4).

Port of ``backpacks_flash_attn_tpu/eval/lm_harness.py``. ``HarnessLM``
implements the harness's model API

    loglikelihood([(context, continuation), ...]) -> [(logprob, is_greedy)]
    loglikelihood_rolling([text, ...])            -> [logprob]
    generate_until([(context, {"until": [...]}), ...]) -> [str]

over the port's Backpack and GPT models on the params' device: requests are
sorted by length and padded into static length buckets, one forward per
(batch, bucket). If the real ``lm_eval`` package is importable,
``to_lm_eval()`` wraps the adapter in its ``LM`` base class so
``lm_eval.simple_evaluate(model=..., tasks=[...])`` works directly.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.quant import QuantTable, QuantWeight

GPT2_EOT = 50256


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _first_leaf(tree):
    """The first leaf in sorted-key order (JAX's ``tree.leaves``); a
    quantized linear or table reads as its int8 codes."""
    if isinstance(tree, dict):
        return _first_leaf(tree[sorted(tree)[0]])
    if isinstance(tree, (QuantWeight, QuantTable)):
        return tree.q
    return tree


class HarnessLM:
    """Batched likelihood/generation scorer with the lm-eval model API.

    apply_fn(params, ids (b, s) long) -> logits (b, s, vocab); tokenizer
    needs .encode(str) -> List[int] and .decode(List[int]) -> str (the
    package GPT2Tokenizer, utils/tokenizer.py)."""

    def __init__(self, apply_fn: Callable, params, tokenizer, *,
                 max_length: int = 512, batch_size: int = 8,
                 eot_token_id: int = GPT2_EOT,
                 buckets: Sequence[int] = (64, 128, 256, 512, 1024),
                 generate_fn: Optional[Callable] = None):
        self.apply_fn = apply_fn
        self.params = params
        self.tok = tokenizer
        self.max_length = max_length
        self.batch_size = batch_size
        self.eot = eot_token_id
        self.buckets = sorted({min(b, max_length) for b in buckets})
        self.generate_fn = generate_fn
        self.device = _first_leaf(params).device
        self._engine = None

    # ---------------------------------------------------------- constructors

    @classmethod
    def backpack(cls, params, cfg, tokenizer, *, engine: bool = False,
                 engine_kwargs: Optional[dict] = None, **kw) -> "HarnessLM":
        """engine=True serves generate_until through the continuous-batching
        ServingEngine (one admission per request, shared decode steps)
        instead of one generation per prompt; engine_kwargs passes engine
        knobs through, e.g. {'spec_tokens': 4}. The engine's cache takes
        the params' dtype (int8 for a quantized tree), the loop's bf16, as
        in JAX."""
        from ..models import backpack as bp
        from ..utils import generation as gen

        def apply_fn(p, ids):
            return bp.backpack_forward(p, cfg, ids)

        def generate_fn(p, ids, max_length):
            return gen.generate_backpack(p, cfg, ids, max_length,
                                         device=ids.device).sequences

        kw.setdefault("max_length", cfg.n_positions)
        self = cls(apply_fn, params, tokenizer, generate_fn=generate_fn, **kw)
        if engine:
            from ..serving.engine import ServingEngine
            self._engine = ServingEngine(
                params, cfg, max_slots=self.batch_size,
                max_seqlen=self.max_length, eos_id=self.eot,
                cache_dtype=_first_leaf(params).dtype,
                device=self.device, **(engine_kwargs or {}))
        return self

    @classmethod
    def gpt(cls, params, cfg, tokenizer, **kw) -> "HarnessLM":
        from ..models import gpt as gpt_lib
        from ..utils import generation as gen

        def apply_fn(p, ids):
            h = gpt_lib.gpt_forward(p, cfg, ids)
            return gpt_lib.lm_logits(p, cfg, h)

        def generate_fn(p, ids, max_length):
            return gen.generate_gpt(p, cfg, ids, max_length,
                                    device=ids.device).sequences

        kw.setdefault("max_length", cfg.n_positions)
        return cls(apply_fn, params, tokenizer, generate_fn=generate_fn, **kw)

    # ---------------------------------------------------------- scoring core

    @torch.no_grad()
    def _score(self, ids: torch.Tensor, cont_start: torch.Tensor,
               total_len: torch.Tensor):
        """Per-row continuation logprob sums and greedy flags of one padded
        (batch, bucket) block (JAX's jitted scorer, :117)."""
        logits = self.apply_fn(self.params, ids).float()
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        targets = ids[:, 1:]
        tlp = logp.gather(-1, targets[..., None])[..., 0]          # (b, L-1)
        greedy = logp.argmax(dim=-1) == targets
        # positions t in [cont_start-1, total_len-1) predict the
        # continuation tokens ids[cont_start:total_len]
        pos = torch.arange(ids.shape[1] - 1, device=ids.device)[None, :]
        m = (pos >= cont_start[:, None] - 1) & (pos < total_len[:, None] - 1)
        return (tlp * m).sum(-1), torch.where(m, greedy, True).all(-1)

    def _score_token_requests(
            self, reqs: List[Tuple[List[int], List[int]]]
    ) -> List[Tuple[float, bool]]:
        """reqs: (context_tokens, continuation_tokens) pairs -> per-request
        (sum logprob of continuation, continuation is the greedy decode)."""
        order = sorted(range(len(reqs)),
                       key=lambda i: -(len(reqs[i][0]) + len(reqs[i][1])))
        out: List[Optional[Tuple[float, bool]]] = [None] * len(reqs)
        bs = self.batch_size
        for start in range(0, len(order), bs):
            chunk = order[start:start + bs]
            rows, conts, totals = [], [], []
            for i in chunk:
                ctx, cont = reqs[i]
                ctx = ctx or [self.eot]   # empty context scores from BOS=eot
                toks = (ctx + cont)[-self.max_length:]
                cont_start = max(len(toks) - len(cont), 1)
                rows.append(toks)
                conts.append(cont_start)
                totals.append(len(toks))
            L = _bucket(max(totals), self.buckets)
            ids = np.full((bs, L), self.eot, np.int64)
            for r, toks in enumerate(rows):
                ids[r, :len(toks)] = toks[:L]
            pad = (0, bs - len(chunk))
            lp, greedy = self._score(
                torch.from_numpy(ids).to(self.device),
                torch.from_numpy(np.pad(conts, pad, constant_values=1)
                                 ).to(self.device),
                torch.from_numpy(np.pad(totals, pad, constant_values=1)
                                 ).to(self.device))
            lp, greedy = lp.cpu().numpy(), greedy.cpu().numpy()
            for r, i in enumerate(chunk):
                out[i] = (float(lp[r]), bool(greedy[r]))
        return out  # type: ignore[return-value]

    # ------------------------------------------------------- lm-eval surface

    def loglikelihood(self, requests: Sequence[Tuple[str, str]]
                      ) -> List[Tuple[float, bool]]:
        """[(context, continuation)] -> [(logprob, is_greedy)] (the harness's
        multiple-choice / cloze primitive)."""
        return self._score_token_requests(
            [(self.tok.encode(ctx), self.tok.encode(cont))
             for ctx, cont in requests])

    def loglikelihood_rolling(self, texts: Sequence[str]) -> List[float]:
        """Full-text loglikelihood in disjoint max_length windows, each
        conditioned on BOS only (harness perplexity-task semantics)."""
        win = self.max_length - 1
        window_reqs, owners = [], []
        for i, text in enumerate(texts):
            toks = self.tok.encode(text)
            for s in range(0, max(len(toks), 1), win):
                window_reqs.append(([], toks[s:s + win]))
                owners.append(i)
        scored = self._score_token_requests(window_reqs)
        totals = [0.0] * len(texts)
        for owner, (lp, _) in zip(owners, scored):
            totals[owner] += lp
        return totals

    @staticmethod
    def _cut(text: str, stops: Sequence[str]) -> str:
        for s in stops:
            idx = text.find(s)
            if idx >= 0:
                text = text[:idx]
        return text

    def generate_until(self, requests: Sequence[Tuple[str, Dict]]
                       ) -> List[str]:
        """[(context, {"until": [stops], "max_gen_toks": n})] -> completions,
        greedy, truncated at the first stop sequence."""
        if self._engine is not None:
            return self._generate_until_served(requests)
        if self.generate_fn is None:
            raise ValueError("this HarnessLM was built without a generate_fn")
        out = []
        for ctx, kwargs in requests:
            max_new = int(kwargs.get("max_gen_toks", 32))
            toks = self.tok.encode(ctx) or [self.eot]
            toks = toks[-(self.max_length - max_new):]
            ids = torch.tensor([toks], dtype=torch.long, device=self.device)
            seq = self.generate_fn(self.params, ids, len(toks) + max_new)
            text = self.tok.decode(seq[0, len(toks):].tolist())
            out.append(self._cut(text, kwargs.get("until", [])))
        return out

    def _generate_until_served(self, requests) -> List[str]:
        """Continuous-batching generation: every request is admitted to the
        ServingEngine and decoded in shared steps (greedy, EOS = eot)."""
        rids, metas = [], []
        for ctx, kwargs in requests:
            max_new = int(kwargs.get("max_gen_toks", 32))
            toks = (self.tok.encode(ctx) or [self.eot])
            toks = toks[-(self.max_length - max_new):]
            rids.append(self._engine.submit(toks, max_new_tokens=max_new))
            metas.append(list(kwargs.get("until", [])))
        results = self._engine.run()
        out = []
        for rid, stops in zip(rids, metas):
            toks = results[rid].tokens
            if toks and toks[-1] == self.eot:   # engine stops AT eos
                toks = toks[:-1]
            out.append(self._cut(self.tok.decode(toks), stops))
        return out

    # ---------------------------------------------------------- lm_eval glue

    def to_lm_eval(self):
        """Wrap as a real lm_eval.api.model.LM (requires the lm_eval
        package; raises ImportError without it)."""
        from lm_eval.api.model import LM  # noqa: deferred heavy import

        adapter = self

        class _Wrapped(LM):
            def loglikelihood(self, requests):
                return adapter.loglikelihood(
                    [req.args for req in requests])

            def loglikelihood_rolling(self, requests):
                return adapter.loglikelihood_rolling(
                    [req.args[0] for req in requests])

            def generate_until(self, requests):
                return adapter.generate_until(
                    [req.args for req in requests])

        return _Wrapped()


# ----------------------------------------------------------- simple tasks

def multiple_choice_accuracy(lm: HarnessLM,
                             items: Sequence[Dict]) -> Dict[str, float]:
    """Score a list of {context, choices, gold} items (the harness's
    multiple-choice task shape, e.g. LAMBADA cloze / HellaSwag endings):
    prediction = argmax over per-choice continuation loglikelihood."""
    reqs = [(it["context"], c) for it in items for c in it["choices"]]
    scores = lm.loglikelihood(reqs)
    correct, pos = 0, 0
    for it in items:
        n = len(it["choices"])
        lps = [scores[pos + j][0] for j in range(n)]
        correct += int(int(np.argmax(lps)) == it["gold"])
        pos += n
    return {"acc": correct / max(len(items), 1), "n": float(len(items))}
