"""Continuous-batching serving engine for Backpack LMs (PyTorch port).

Port of ``backpacks_flash_attn_tpu/serving/engine.py`` (``ServingEngine``
:83):

  * a fixed (max_slots, max_seqlen) per-slot cache with a staging block
    (``stage_tokens``, default 64): decode steps append to the block at a
    scalar pointer, and the engine flushes it into the main cache when it
    fills; a decode step attends over the main cache through K1's (m, l)
    form (K8-ml over an int4 GPT cache) merged with the staged columns
  * admission: prompts prefill batched, grouped by power-of-two length
    bucket (one prefill per group, K3 through the flash wrapper), or in
    fixed-width chunks (``prefill_chunk``), into a per-slot cache whose rows
    are then copied into free slots
  * one decode step advances every active slot; finished requests retire
    and their slots are reused at once
  * scheduling (queue, slots, budgets, EOS) in the native C++ scheduler
    (csrc/scheduler.cpp, built with g++) or its Python twin
  * per-request sampling (greedy, temperature, top-p, top-k), stop
    sequences, min_new_tokens, frequency/presence penalties, logprobs and
    (nv,) sense weights
  * prompt-lookup and model-draft speculation (``spec_tokens``), adaptive

JAX compiles one program per shape and keeps them in ``_jit_*`` dicts; the
port runs eagerly, so each of those is a plain method here, and JAX's
power-of-two padding of a prefill group's rows (compile reuse) is dropped.
Sampling keys are ``utils.prng`` keys split as JAX splits them, and the
Gumbel draw is ``jax.random.categorical``'s, so a seeded engine samples the
JAX engine's tokens wherever the logits agree. Topic-control and
negative-weighted requests (``control_table``, ``negative_table``) wait
for ``models/interventions.py`` (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import BackpackConfig
from ..models import backpack as bp
from ..models import gpt as gpt_lib
from ..ops import _build
from ..utils import prng
from .scheduler import make_scheduler


@dataclasses.dataclass
class RequestResult:
    request_id: int
    tokens: List[int]
    finished: bool
    # per-emitted-token log p(token) under the temperature-1 distribution of
    # the final adjusted logits (after penalties and eos suppression, before
    # temperature/top-p/top-k); None unless submitted with logprobs=True
    logprobs: Optional[List[float]] = None


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def prompt_lookup_draft(hist: np.ndarray, k: int,
                        max_ngram: int = 3) -> np.ndarray:
    """Prompt-lookup draft (host-side numpy, JAX :58): the k tokens that
    followed the most recent earlier occurrence of hist's trailing n-gram,
    backing off to shorter n-grams, then to repeating the last token.
    hist: (L,) int tokens, L >= 1."""
    L = hist.shape[0]
    draft = np.full((k,), hist[-1] if L else 0, np.int32)
    for n in range(min(max_ngram, L - 1), 0, -1):
        pat = hist[L - n:L]
        win = np.lib.stride_tricks.sliding_window_view(hist[:L - 1], n)
        hits = np.nonzero((win == pat).all(axis=1))[0]
        if hits.size == 0:
            continue
        p = int(hits[-1])
        cont = hist[p + n:p + n + k]
        if cont.size:
            draft[:cont.size] = cont
            return draft
    return draft


class ServingEngine:
    def __init__(self, params, cfg: BackpackConfig, *, max_slots: int = 8,
                 max_seqlen: int = 512, cache_dtype=torch.bfloat16,
                 eos_id: int = 50256, use_flash: bool = True, seed: int = 0,
                 num_senses: Optional[int] = None,
                 control_table: Optional[np.ndarray] = None,
                 annealing_scale: float = 0.2,
                 prefer_native_scheduler: bool = True,
                 window_buckets: Optional[Tuple[int, ...]] = None,
                 negative_table: Optional[np.ndarray] = None,
                 negative_quantile: float = 0.02,
                 negative_anneal: bool = False,
                 negative_annealing_scale: float = 0.34,
                 spec_tokens: int = 0, spec_ngram: int = 3,
                 spec_min_acceptance: float = 0.05,
                 spec_cooldown: int = 16,
                 prefill_chunk: int = 0,
                 stage_tokens: int = 64,
                 draft_params=None,
                 draft_cfg: Optional[BackpackConfig] = None,
                 draft_cache_dtype=torch.int8,
                 device="cuda"):
        """JAX's signature (:84), with ``cache_dtype`` a torch dtype and
        the device the engine allocates on. ``params`` must lie on that
        device. use_flash=False has no port: attention always takes the
        flash wrappers, and ``ops._build.plain_path()`` is the one switch
        to the plain versions. num_senses, annealing_scale and the
        negative_* options belong to the intervention modes, which raise
        (ROADMAP Queue 1 item 5).

        spec_tokens > 0: speculation. Each step drafts spec_tokens tokens
        per slot, by prompt lookup over the slot's own history (newest
        spec_ngram-gram), or with ``draft_params``/``draft_cfg`` by a
        smaller Backpack's greedy decode over its own per-slot cache; one
        (1 + k)-token verification step scores them. Greedy slots keep the
        longest prefix that matches the model's argmax, so their output
        equals plain greedy decoding; sampling slots take one token a step.
        spec_min_acceptance > 0 makes it adaptive: when the acceptance of
        the last 32 speculative steps (after 8) falls below it, the engine
        steps plainly for spec_cooldown steps.

        prefill_chunk > 0 admits through fixed-width chunks at advancing
        per-row offsets instead of one prefill per length bucket.
        stage_tokens: the staging block's width (0: per-row writes into
        the main cache every step)."""
        if control_table is not None or negative_table is not None:
            raise NotImplementedError(
                "control_table / negative_table need models/interventions.py, "
                "not ported yet (ROADMAP Queue 1 item 5)")
        if not use_flash:
            raise ValueError("use_flash=False has no port: use "
                             "ops._build.plain_path() for the plain versions")
        self.device = _build.resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seqlen = max_seqlen
        self.eos_id = eos_id
        self.sched = make_scheduler(max_slots, max_seqlen, eos_id,
                                    prefer_native=prefer_native_scheduler)
        self.cache_dtype = cache_dtype
        self._stage_cap = int(stage_tokens)
        self._stage_used = 0
        self.cache = bp.init_backpack_cache(
            cfg, max_slots, max_seqlen, cache_dtype, device=self.device,
            per_slot=True, stage=self._stage_cap)
        # host-side per-slot positions: the engine picks a static window
        # bucket per step without reading the card's lengths
        self.host_lengths = np.zeros((max_slots,), np.int64)
        if window_buckets is None:
            window_buckets = (128, 256, 384, max_seqlen)
        self.window_buckets = sorted({min(b, max_seqlen) for b in
                                      window_buckets
                                      if b <= max_seqlen} | {max_seqlen})
        self.tokens = torch.zeros((max_slots, 1), dtype=torch.long,
                                  device=self.device)
        self.temps = np.zeros((max_slots,), np.float32)   # 0 = greedy
        self.sense_weights = np.ones((max_slots, cfg.num_senses), np.float32)
        self._uses_weights = False
        self._rng = prng.PRNGKey(seed)
        self._next_id = 0
        self.prefill_dispatches = 0
        self._clock = time.perf_counter
        self._stats = collections.Counter()
        self.top_ps = np.ones((max_slots,), np.float32)
        self._uses_top_p = False
        self._meta_top_p: Dict[int, float] = {}
        self.top_ks = np.zeros((max_slots,), np.int32)
        self._uses_top_k = False
        self._meta_top_k: Dict[int, int] = {}
        self._meta_stop: Dict[int, list] = {}
        self.stop_seqs = [[] for _ in range(max_slots)]
        self._meta_min: Dict[int, int] = {}
        self.min_tokens = np.zeros((max_slots,), np.int64)
        self.emitted = np.zeros((max_slots,), np.int64)
        self._uses_min = False
        self._meta_penalty: Dict[int, tuple] = {}
        self._meta_logprobs: Dict[int, bool] = {}
        self.logprob_mask = np.zeros((max_slots,), bool)
        self._slot_logprobs: List[List[float]] = [[] for _ in
                                                  range(max_slots)]
        self._uses_logprobs = False
        self.freq_p = np.zeros((max_slots,), np.float32)
        self.pres_p = np.zeros((max_slots,), np.float32)
        # per-slot token counts (prompt + emitted), allocated with the first
        # penalized request: only penalized slots read them, and theirs are
        # set at admission and counted every step from then on
        self.token_counts: Optional[torch.Tensor] = None
        self._uses_penalty = False
        self._window_hist = collections.Counter()
        self.spec_tokens = int(spec_tokens)
        self.spec_ngram = int(spec_ngram)
        self.spec_min_acceptance = float(spec_min_acceptance)
        self.spec_cooldown = int(spec_cooldown)
        self._spec_recent = collections.deque(maxlen=32)
        self._spec_skip_until = 0
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk and max_seqlen % self.prefill_chunk:
            raise ValueError(f"prefill_chunk {prefill_chunk} must divide "
                             f"max_seqlen {max_seqlen}")
        self.host_tokens = np.zeros((max_slots, max_seqlen + spec_tokens + 2),
                                    np.int32)
        self.hist_len = np.zeros((max_slots,), np.int64)
        # model-draft speculation: the draft keeps its own per-slot cache,
        # whose lengths resync from host_lengths at every draft step (the
        # rollback of rejected draft rows)
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.draft_cache = None
        self.draft_cache_dtype = draft_cache_dtype
        if draft_params is not None and self.spec_tokens > 0:
            if draft_cfg is None:
                raise ValueError("draft_params requires draft_cfg")
            self.draft_cache = bp.init_backpack_cache(
                draft_cfg, max_slots, max_seqlen, draft_cache_dtype,
                device=self.device, per_slot=True)
        self._t_first_step = None
        self._meta: Dict[int, tuple] = {}
        self._prompts: Dict[int, np.ndarray] = {}
        self._results: Dict[int, RequestResult] = {}

    # ------------------------------------------------------------ submit

    def submit(self, prompt, *, max_new_tokens: int = 64,
               min_new_tokens: int = 0,
               temperature: float = 0.0, top_p: float = 1.0, top_k: int = 0,
               frequency_penalty: float = 0.0, presence_penalty: float = 0.0,
               sense_weights: Optional[np.ndarray] = None,
               control: bool = False, negative: bool = False,
               stop: Optional[List[List[int]]] = None,
               logprobs: bool = False) -> int:
        """Queue a request; returns its id, or raises if the prompt can
        never fit the cache (JAX :306). stop: token-id sequences that end
        generation, EXCLUDED from the result (an eos stays).
        min_new_tokens: suppress eos until that many tokens are out.
        frequency/presence penalties: OpenAI-style, from per-slot counts of
        prompt and emitted tokens (speculation steps plainly while a
        penalized slot is active). sense_weights: (nv,) multiplicative
        weights on the request's senses. control/negative need the
        intervention tables, which the port does not take yet."""
        if control or negative:
            raise ValueError("control=True / negative=True need a "
                             "control_table / negative_table on the engine")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        rid = self._next_id
        self._next_id += 1
        if not self.sched.submit(rid, len(prompt), max_new_tokens):
            raise ValueError(
                f"prompt of {len(prompt)} tokens cannot fit max_seqlen="
                f"{self.max_seqlen}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        self._prompts[rid] = prompt
        self._meta[rid] = (temperature, sense_weights)
        self._meta_top_p[rid] = top_p
        self._meta_top_k[rid] = top_k
        if stop:
            self._meta_stop[rid] = [np.asarray(s, np.int64).reshape(-1)
                                    for s in stop if len(s)]
        if min_new_tokens:
            self._meta_min[rid] = int(min_new_tokens)
        if frequency_penalty or presence_penalty:
            self._meta_penalty[rid] = (float(frequency_penalty),
                                       float(presence_penalty))
        if logprobs:
            self._meta_logprobs[rid] = True
        return rid

    # ------------------------------------------------------------ sampling

    def _dev(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    @staticmethod
    def _apply_penalties(last, counts, freq_p, pres_p):
        """OpenAI-style additive penalties from per-slot token counts:
        logits - freq * count - pres * (count > 0) (JAX :369)."""
        c = counts.float()
        return (last - freq_p[:, None] * c
                - pres_p[:, None] * (c > 0).float())

    @staticmethod
    def _sample_tokens(last, temps, rng, top_ps=None, top_ks=None,
                       eos_ban=None, eos_id=0, return_lp=False):
        """Per-slot greedy / temperature (+ nucleus, top-k) sampling in one
        batched op (JAX :377); temps None means every row greedy (the
        engine passes None when no active slot samples: the Gumbel draw
        over the whole vocabulary is then skipped, and no other key
        changes). eos_ban: (b,) bool rows still under min_new_tokens.
        return_lp: also the chosen token's log-probability under the
        temperature-1 post-ban distribution."""
        if eos_ban is not None:
            col = torch.arange(last.shape[-1], device=last.device) == eos_id
            last = torch.where(eos_ban[:, None] & col[None, :], -torch.inf,
                               last)
        nxt = last.argmax(dim=-1)
        if temps is not None:
            logits = last / torch.clamp_min(temps, 1e-6)[:, None]
            if top_ps is not None or top_ks is not None:
                sorted_l = torch.sort(logits, dim=-1, descending=True).values
                cutoff = torch.full((logits.shape[0], 1), -torch.inf,
                                    device=last.device)
                if top_ps is not None:
                    # keep the smallest descending-prob prefix with cum > p
                    probs = torch.softmax(sorted_l, dim=-1)
                    keep = torch.cumsum(probs, dim=-1) - probs < top_ps[:, None]
                    cutoff = torch.where(keep, sorted_l, torch.inf).amin(
                        dim=-1, keepdim=True)
                if top_ks is not None:
                    # kth-largest logit per row; top_k <= 0 is unrestricted
                    idx = torch.clamp(top_ks.long() - 1, 0, logits.shape[-1] - 1)
                    kth = sorted_l.gather(1, idx[:, None])
                    kth = torch.where((top_ks > 0)[:, None], kth, -torch.inf)
                    cutoff = torch.maximum(cutoff, kth)
                logits = torch.where(logits < cutoff, -torch.inf, logits)
            nxt = torch.where(temps > 0, prng.categorical(rng, logits), nxt)
        if not return_lp:
            return nxt
        lp = torch.log_softmax(last, dim=-1).gather(1, nxt[:, None])[:, 0]
        return nxt, lp

    def _step_args(self):
        """The sampling options of the active slots as device tensors
        (None where no active slot uses one)."""
        active = [sl for sl in range(self.max_slots)
                  if self.sched.slot_active(sl)]
        sampling = any(self.temps[sl] > 0 for sl in active)
        return dict(
            temps=self._dev(self.temps) if sampling else None,
            top_ps=self._dev(self.top_ps) if self._uses_top_p else None,
            top_ks=self._dev(self.top_ks) if self._uses_top_k else None)

    def _weights(self):
        return (self._dev(self.sense_weights) if self._uses_weights
                else None)

    # ------------------------------------------------------------ steps

    def _window(self, extra: int = 1) -> int:
        """Smallest length bucket covering every active slot after this
        step (host-tracked positions; no device read). ``extra``: the new
        cache rows this step writes (1, or spec_tokens + 1)."""
        active = [self.host_lengths[sl] for sl in range(self.max_slots)
                  if self.sched.slot_active(sl)]
        need = (max(active) if active else 0) + extra
        for b in self.window_buckets:
            if b >= need:
                return b
        return self.max_seqlen

    def _step_fn(self, cache, window: int, rng):
        """One decode step of every slot (JAX :465): forward, penalties,
        sampling; self.tokens becomes the next tokens. Returns the
        logprobs (or None)."""
        win = None if window >= self.max_seqlen else window
        logits, _ = bp.backpack_forward_with_cache(
            self.params, self.cfg, self.tokens, cache, window=win,
            sense_weights=self._weights())
        last = logits[:, -1].float()
        if self._uses_penalty:
            last = self._apply_penalties(last, self.token_counts,
                                         self._dev(self.freq_p),
                                         self._dev(self.pres_p))
        ban = (self._dev(self.emitted < self.min_tokens) if self._uses_min
               else None)
        out = self._sample_tokens(last, rng=rng, eos_ban=ban,
                                  eos_id=self.eos_id,
                                  return_lp=self._uses_logprobs,
                                  **self._step_args())
        nxt, lp = out if self._uses_logprobs else (out, None)
        if self.token_counts is not None:
            self.token_counts[torch.arange(self.max_slots,
                                           device=self.device), nxt] += 1
        self.tokens = nxt[:, None]
        return lp

    def _spec_step_fn(self, cache, window: int, drafts: torch.Tensor, rng):
        """Speculative verification (JAX :502): ONE (b, 1+k) step scores the
        in-flight token and the k drafts. Greedy slots accept the longest
        draft prefix matching the model's argmax and emit acc + 1 tokens;
        sampling slots emit one token drawn from position 0. The lengths
        roll back to old + acc + 1, so rejected rows are masked and then
        overwritten. Returns (emitted (b, 1+k), n_emit (b,), logprobs)."""
        k = self.spec_tokens
        win = None if window >= self.max_seqlen else window
        inp = torch.cat([self.tokens, drafts], dim=1)
        old_len = cache.length
        logits, _ = bp.backpack_forward_with_cache(
            self.params, self.cfg, inp, cache, window=win,
            sense_weights=self._weights())
        logits = logits.float()
        if self._uses_min:
            # position t emits token #(emitted + t + 1): ban eos while that
            # count is under min_new_tokens
            ban_t = (self._dev(self.emitted)[:, None]
                     + torch.arange(k + 1, device=self.device)[None]
                     < self._dev(self.min_tokens)[:, None])
            col = torch.arange(logits.shape[-1], device=self.device) == self.eos_id
            logits = torch.where(ban_t[..., None] & col, -torch.inf, logits)
        preds = logits.argmax(dim=-1)                            # (b, 1+k)
        match = (preds[:, :-1] == drafts).long()
        acc = torch.cumprod(match, dim=1).sum(dim=1)
        args = self._step_args()
        greedy = (self._dev(self.temps) <= 0)
        acc = torch.where(greedy, acc, 0)
        bonus = preds.gather(1, acc[:, None])[:, 0]
        sampled0 = self._sample_tokens(logits[:, 0], rng=rng, **args)
        head = torch.where(greedy, bonus, sampled0)
        tpos = torch.arange(k + 1, device=self.device)[None]
        dpad = torch.nn.functional.pad(drafts, (0, 1))
        emitted = torch.where(tpos < acc[:, None], dpad,
                              torch.where(tpos == acc[:, None],
                                          head[:, None], 0))
        n_emit = acc + 1
        cache.length = old_len + n_emit.to(old_len.dtype)
        cache.gpt.length = cache.length.clone()
        lp = None
        if self._uses_logprobs:
            lp = torch.log_softmax(logits, dim=-1).gather(
                2, emitted[..., None])[..., 0]
        self.tokens = head[:, None]
        return emitted, n_emit, lp

    # ------------------------------------------------------- model drafts

    def _draft_k_fn(self, window: int) -> torch.Tensor:
        """k greedy decode steps of the draft model over its own cache
        (JAX :579), lengths resynced from the host first (rolling back
        rejected draft rows, and following reused slots) -> (b, k)."""
        win = None if window >= self.max_seqlen else window
        lens = self._dev(self.host_lengths.astype(np.int32))
        self.draft_cache.length = lens
        self.draft_cache.gpt.length = lens.clone()
        tok, drafts = self.tokens, []
        for _ in range(self.spec_tokens):
            logits, _ = bp.backpack_forward_with_cache(
                self.draft_params, self.draft_cfg, tok, self.draft_cache,
                window=win)
            tok = logits[:, -1].argmax(dim=-1)[:, None]
            drafts.append(tok)
        return torch.cat(drafts, dim=1)

    def _draft_prefill_fn(self, ids, lens):
        """The draft model's prefill of an admission group (JAX :611)."""
        small = bp.init_backpack_cache(
            self.draft_cfg, ids.shape[0], self.max_seqlen,
            self.draft_cache_dtype, device=self.device, per_slot=True)
        bp.backpack_forward_with_cache(self.draft_params, self.draft_cfg,
                                       ids, small)
        small.length = lens
        small.gpt.length = lens.clone()
        return small

    def _admit_draft(self, recs, slots) -> None:
        """Prefill the draft cache for an admission group (its own padded
        batch, so chunked admissions work too)."""
        dbucket = min(_bucket(max(r[2] for r in recs)), self.max_seqlen)
        ids = np.zeros((len(recs), dbucket), np.int32)
        for i, rec in enumerate(recs):
            ids[i, :rec[2]] = self._prompts[rec[1]]
        lens = self._dev([r[2] for r in recs], torch.int32)
        small = self._draft_prefill_fn(self._dev(ids, torch.long), lens)
        self._insert_rows_fn(self.draft_cache, small, slots, self.draft_cfg)

    def _build_drafts(self) -> np.ndarray:
        """Per-slot prompt-lookup drafts over the host-tracked histories."""
        drafts = np.zeros((self.max_slots, self.spec_tokens), np.int32)
        for slot in range(self.max_slots):
            if not self.sched.slot_active(slot):
                continue
            hist = self.host_tokens[slot, :int(self.hist_len[slot])]
            drafts[slot] = prompt_lookup_draft(hist, self.spec_tokens,
                                               self.spec_ngram)
        return drafts

    # ------------------------------------------------------------ admission

    def _batch_prefill_fn(self, ids: np.ndarray, lens: np.ndarray, ws):
        """One prefill of a group of plain requests (JAX :799): ids
        (n, bucket) right-padded, per-row true lengths. The causal mask
        keeps each row's pads invisible to its real tokens, so each row's
        last-real-token logits and first true_len cache columns are exact.
        Returns (last logits (n, V) f32, the per-slot cache of the group)."""
        n = ids.shape[0]
        small = bp.init_backpack_cache(self.cfg, n, self.max_seqlen,
                                       self.cache_dtype, device=self.device,
                                       per_slot=True)
        logits, small = bp.backpack_forward_with_cache(
            self.params, self.cfg, self._dev(ids, torch.long), small,
            sense_weights=ws)
        tl = self._dev(lens, torch.int32)
        last = logits[torch.arange(n, device=self.device), tl.long() - 1]
        small.length = tl
        small.gpt.length = tl.clone()
        return last.float(), small

    def _chunk_prefill_fn(self, ids, true_len, ws, cache, last_prev):
        """One chunk of a chunked prefill (JAX :827): ids (n, W) continue
        every row at its offset; rows whose true length ends inside this
        chunk take their last-real-token logits from it."""
        W = self.prefill_chunk
        logits, cache = bp.backpack_forward_with_cache(
            self.params, self.cfg, ids, cache, sense_weights=ws)
        idx = true_len - 1 - (cache.length.long() - W)
        in_chunk = (idx >= 0) & (idx < W)
        rows = torch.arange(ids.shape[0], device=self.device)
        sel = logits[rows, idx.clamp(0, W - 1)].float()
        return torch.where(in_chunk[:, None], sel, last_prev), cache

    def _chunked_prefill(self, recs, ws):
        """Admit a group through fixed-width chunks (JAX :854); returns
        (last logits (n, V), per-slot cache) like _batch_prefill_fn."""
        W = self.prefill_chunk
        n = len(recs)
        n_chunks = -(-max(r[2] for r in recs) // W)
        ids = np.zeros((n, n_chunks * W), np.int32)
        for i, rec in enumerate(recs):
            ids[i, :rec[2]] = self._prompts[rec[1]]
        ids_d = self._dev(ids, torch.long)
        lens = self._dev([r[2] for r in recs], torch.int32)
        cache = bp.init_backpack_cache(self.cfg, n, self.max_seqlen,
                                       self.cache_dtype, device=self.device,
                                       per_slot=True)
        last = torch.zeros((n, self.cfg.padded_vocab_size),
                           dtype=torch.float32, device=self.device)
        for ci in range(n_chunks):
            last, cache = self._chunk_prefill_fn(
                ids_d[:, ci * W:(ci + 1) * W], lens.long(), ws, cache, last)
            self.prefill_dispatches += 1
        cache.length = lens
        cache.gpt.length = lens.clone()
        return last, cache

    @staticmethod
    def _insert_rows_fn(big, small, slots, cfg) -> None:
        """Copy the rows of a group's per-slot cache into their serving
        slots of ``big`` (JAX :884; the draft cache's too, JAX :630)."""
        for i, slot in enumerate(slots):
            bp.insert_cache_slot(big, bp.extract_cache_slot(small, i, cfg),
                                 slot)

    def _post_admit(self, slot: int, rid: int, plen: int, temp, w, sw,
                    last_logits, greedy_tok: int) -> int:
        """Host bookkeeping of an admission (JAX :904); samples the
        request's first token from its prefill logits (``greedy_tok``, the
        argmax, read with the rest of its group). Returns the token."""
        self.host_lengths[slot] = plen
        self.temps[slot] = temp
        self.sense_weights[slot] = w
        top_p = self._meta_top_p.pop(rid, 1.0)
        self.top_ps[slot] = top_p
        if top_p < 1.0:
            self._uses_top_p = True
        top_k = self._meta_top_k.pop(rid, 0)
        self.top_ks[slot] = top_k
        if top_k > 0:
            self._uses_top_k = True
        self.stop_seqs[slot] = self._meta_stop.pop(rid, [])
        self.min_tokens[slot] = self._meta_min.pop(rid, 0)
        self.emitted[slot] = 0
        if self.min_tokens[slot] > 0:
            self._uses_min = True
        fp, pp = self._meta_penalty.pop(rid, (0.0, 0.0))
        self.freq_p[slot] = fp
        self.pres_p[slot] = pp
        wants_lp = self._meta_logprobs.pop(rid, False)
        self.logprob_mask[slot] = wants_lp
        self._slot_logprobs[slot] = []
        if wants_lp:
            self._uses_logprobs = True
        if sw is not None:
            self._uses_weights = True
        row = None
        if fp or pp:
            self._uses_penalty = True
            if self.token_counts is None:
                self.token_counts = torch.zeros(
                    (self.max_slots, self.cfg.padded_vocab_size),
                    dtype=torch.int32, device=self.device)
            row = np.zeros((self.cfg.padded_vocab_size,), np.int32)
            ids, cts = np.unique(self._prompts[rid], return_counts=True)
            row[ids] = cts
            rowf = self._dev(row.astype(np.float32))
            last_logits = last_logits - (fp * rowf + pp * (rowf > 0).float())
        ban = self.min_tokens[slot] > 0
        if temp > 0:
            self._rng, sub = prng.split(self._rng)
            tok = int(self._sample_tokens(
                last_logits[None], self._dev([temp], torch.float32), sub,
                self._dev([top_p], torch.float32) if top_p < 1.0 else None,
                self._dev([top_k], torch.int32) if top_k > 0 else None,
                self._dev([True]) if ban else None, self.eos_id)[0])
        elif ban or row is not None:
            tok = int(self._sample_tokens(
                last_logits[None], None, None,
                eos_ban=self._dev([True]) if ban else None,
                eos_id=self.eos_id)[0])
        else:
            tok = greedy_tok
        if wants_lp:
            # admit-time emission: the step paths' temperature-1 post-ban
            # semantics, on the host (one row, once per request)
            r = last_logits.double().cpu().numpy().copy()
            if ban:
                r[self.eos_id] = -np.inf
            r -= r.max()
            self._slot_logprobs[slot].append(
                float(r[tok] - np.log(np.exp(r).sum())))
        if self.token_counts is not None:
            if row is None:
                self.token_counts[slot].zero_()
            else:
                self.token_counts[slot] = self._dev(row)
            self.token_counts[slot, tok] += 1
        self.emitted[slot] = 1
        self.host_tokens[slot, :plen] = self._prompts[rid]
        self.host_tokens[slot, plen] = tok
        self.hist_len[slot] = plen + 1
        return tok

    def _admit_all(self) -> List[int]:
        """Drain the scheduler, then admit by groups: one prefill per
        power-of-two length bucket (or one chunked group), rows copied into
        their slots, first tokens sampled (JAX :980)."""
        plain = []
        while True:
            got = self.sched.admit()
            if got is None:
                break
            slot, rid, plen = got
            temp, sw = self._meta.pop(rid)
            w = (np.ones(self.cfg.num_senses, np.float32) if sw is None
                 else np.asarray(sw, np.float32))
            plain.append((slot, rid, plen, temp, w, sw))
        groups: Dict[int, list] = {}
        for rec in plain:
            key = 0 if self.prefill_chunk else min(_bucket(rec[2]),
                                                   self.max_seqlen)
            groups.setdefault(key, []).append(rec)
        admitted = []
        for bucket, recs in sorted(groups.items()):
            # ones are exact: a group with no weighted request skips them
            ws = (self._dev(np.stack([r[4] for r in recs]))
                  if any(r[5] is not None for r in recs) else None)
            if self.prefill_chunk:
                last, small = self._chunked_prefill(recs, ws)
            else:
                ids = np.zeros((len(recs), bucket), np.int32)
                for i, rec in enumerate(recs):
                    ids[i, :rec[2]] = self._prompts[rec[1]]
                last, small = self._batch_prefill_fn(
                    ids, np.asarray([r[2] for r in recs]), ws)
                self.prefill_dispatches += 1
            slots = [r[0] for r in recs]
            self._insert_rows_fn(self.cache, small, slots, self.cfg)
            if self.draft_cache is not None:
                self._admit_draft(recs, slots)
            del small
            greedy = last.argmax(dim=-1).tolist()
            toks = []
            for i, (slot, rid, plen, temp, w, sw) in enumerate(recs):
                toks.append(self._post_admit(slot, rid, plen, temp, w, sw,
                                             last[i], greedy[i]))
                admitted.append(rid)
            self.tokens[self._dev(slots), 0] = self._dev(toks, torch.long)
            for slot, tok in zip(slots, toks):
                if self.sched.on_token(slot, tok):
                    self._finish(slot)
        return admitted

    def _finish(self, slot: int, trunc: int = 0) -> None:
        rid = self.sched.slot_request(slot)
        tokens = self.sched.slot_tokens(slot)
        if trunc:
            tokens = tokens[:-trunc]
        lps = None
        if self.logprob_mask[slot]:
            lps = self._slot_logprobs[slot]
            if trunc:
                lps = lps[:-trunc]
            self.logprob_mask[slot] = False
            self._slot_logprobs[slot] = []
        self._results[rid] = RequestResult(
            request_id=rid, tokens=tokens, finished=True, logprobs=lps)
        self.top_ps[slot] = 1.0
        self.top_ks[slot] = 0
        self.freq_p[slot] = 0.0
        self.pres_p[slot] = 0.0
        self.stop_seqs[slot] = []
        self.sched.release(slot)

    def _stop_hit(self, slot: int) -> int:
        """Length of the stop sequence the emitted history now ends with
        (0: none)."""
        L = int(self.hist_len[slot])
        for seq in self.stop_seqs[slot]:
            n = seq.shape[0]
            if L >= n and np.array_equal(self.host_tokens[slot, L - n:L],
                                         seq):
                return n
        return 0

    # ------------------------------------------------------------ stepping

    def _plain_view(self) -> bp.BackpackCache:
        """The cache without its staging blocks, sharing the main tensors:
        a sense-weighted step reads and writes the main cache (JAX
        :1112)."""
        c = self.cache
        g = dataclasses.replace(c.gpt, k_stage=None, v_stage=None,
                                ks_stage=None, vs_stage=None, stage_pos=None,
                                stage_ptr=0, base_len=None)
        return dataclasses.replace(c, gpt=g, ctx_k_stage=None,
                                   ctx_ks_stage=None, content_stage=None,
                                   content_ss_stage=None)

    def _restage(self, view: bp.BackpackCache) -> None:
        """After a plain-view step: take its lengths, and empty the stage
        with the flushed horizon at the new length (JAX :1122)."""
        self.cache.length = view.length
        self.cache.gpt.length = view.gpt.length
        gpt_lib.reset_stage(self.cache.gpt)

    @torch.no_grad()
    def step(self) -> List[Tuple[int, int, bool]]:
        """Admit whatever fits, then run ONE decode step of every active
        slot (JAX :1139). Returns [(request_id, token, finished)]."""
        if self._t_first_step is None:
            self._t_first_step = self._clock()
        t0 = self._clock()
        admitted = self._admit_all()
        self._stats["admissions"] += len(admitted)
        if self.sched.num_active == 0:
            return []
        self._rng, sub = prng.split(self._rng)
        k = self.spec_tokens
        cache = self.cache
        if self._stage_cap:
            if self._uses_weights:
                if self._stage_used:
                    bp.flush_cache(self.cache)
                    self._stage_used = 0
                    self._stats["flushes"] += 1
                cache = self._plain_view()
            elif self._stage_used + k + 1 > self._stage_cap:
                bp.flush_cache(self.cache)
                self._stage_used = 0
                self._stats["flushes"] += 1
        active = [sl for sl in range(self.max_slots)
                  if self.sched.slot_active(sl)]
        max_active_len = max(int(self.host_lengths[sl]) for sl in active)
        active_pen = any(self.freq_p[sl] or self.pres_p[sl] for sl in active)
        if (k > 0 and not active_pen
                and max_active_len + k + 1 <= self.max_seqlen
                and self._stats["decode_steps"] >= self._spec_skip_until):
            return self._spec_step(cache, t0, sub)
        window = self._window()
        self._window_hist[window] += 1
        lp_arr = self._step_fn(cache, window, sub)
        self._after_step(cache, 1)
        toks = self.tokens[:, 0].tolist()
        lps = lp_arr.tolist() if lp_arr is not None else None
        out = []
        for slot in active:
            self.host_lengths[slot] += 1
            self.host_tokens[slot, self.hist_len[slot]] = toks[slot]
            self.hist_len[slot] += 1
            self.emitted[slot] += 1
            if self.logprob_mask[slot]:
                self._slot_logprobs[slot].append(lps[slot])
            rid = self.sched.slot_request(slot)
            finished = self.sched.on_token(slot, toks[slot])
            if not finished and self.stop_seqs[slot]:
                hit = self._stop_hit(slot)
                if hit:
                    out.append((rid, toks[slot], True))
                    self._finish(slot, trunc=hit)
                    self._stats["completed"] += 1
                    continue
            out.append((rid, toks[slot], finished))
            if finished:
                self._finish(slot)
                self._stats["completed"] += 1
        self._stats["decode_steps"] += 1
        self._stats["tokens_emitted"] += len(out)
        self._stats["step_time_ns"] += int((self._clock() - t0) * 1e9)
        return out

    def _after_step(self, cache, rows: int) -> None:
        if cache is not self.cache:
            self._restage(cache)
        elif self._stage_cap:
            self._stage_used += rows

    def _spec_step(self, cache, t0, sub) -> List[Tuple[int, int, bool]]:
        """The speculative branch of :meth:`step` (JAX :1176-1243)."""
        k = self.spec_tokens
        window = self._window(extra=k + 1)
        self._window_hist[window] += 1
        if self.draft_cache is not None:
            drafts = self._draft_k_fn(window)
        else:
            drafts = self._dev(self._build_drafts(), torch.long)
        emitted, n_emit, lp_arr = self._spec_step_fn(cache, window, drafts,
                                                     sub)
        self._after_step(cache, k + 1)
        em, ne = emitted.tolist(), n_emit.tolist()
        lps = lp_arr.tolist() if lp_arr is not None else None
        out = []
        step_prop = step_acc = 0
        for slot in range(self.max_slots):
            if not self.sched.slot_active(slot):
                continue
            take = int(ne[slot])
            self.host_lengths[slot] += take
            self._stats["draft_proposed"] += k
            self._stats["draft_accepted"] += take - 1
            step_prop += k
            step_acc += take - 1
            rid = self.sched.slot_request(slot)
            for t in range(take):
                tok = int(em[slot][t])
                self.host_tokens[slot, self.hist_len[slot]] = tok
                self.hist_len[slot] += 1
                self.emitted[slot] += 1
                if self.logprob_mask[slot]:
                    self._slot_logprobs[slot].append(lps[slot][t])
                finished = self.sched.on_token(slot, tok)
                hit = (0 if finished or not self.stop_seqs[slot]
                       else self._stop_hit(slot))
                out.append((rid, tok, finished or hit > 0))
                if finished or hit:
                    self._finish(slot, trunc=hit)
                    self._stats["completed"] += 1
                    break
        if self.spec_min_acceptance > 0.0 and step_prop:
            self._spec_recent.append((step_prop, step_acc))
            if len(self._spec_recent) >= 8:
                prop = sum(p for p, _ in self._spec_recent)
                acc = sum(a for _, a in self._spec_recent)
                if acc < self.spec_min_acceptance * prop:
                    self._spec_skip_until = (
                        self._stats["decode_steps"] + self.spec_cooldown)
                    self._spec_recent.clear()
                    self._stats["spec_cooldowns"] += 1
        self._stats["decode_steps"] += 1
        self._stats["tokens_emitted"] += len(out)
        self._stats["step_time_ns"] += int((self._clock() - t0) * 1e9)
        return out

    def run(self) -> Dict[int, RequestResult]:
        """Drive until every submitted request completes."""
        while self.sched.num_pending or self.sched.num_active:
            self.step()
        out, self._results = self._results, {}
        return out

    def generate(self, prompts, **kw) -> List[List[int]]:
        """Submit every prompt with the same options, run to completion,
        return token lists in prompt order."""
        rids = [self.submit(p, **kw) for p in prompts]
        results = self.run()
        return [results[r].tokens for r in rids]

    # --------------------------------------------------------- observability

    def stats(self) -> Dict[str, object]:
        """Host-side serving metrics since engine start (JAX :1334):
        counters (admissions, decode steps, tokens, flushes, ...), the
        window histogram and derived rates."""
        s = dict(self._stats)
        s["prefill_dispatches"] = self.prefill_dispatches
        s["active_slots"] = self.sched.num_active
        s["pending_requests"] = self.sched.num_pending
        s["window_histogram"] = dict(sorted(self._window_hist.items()))
        wall = (self._clock() - self._t_first_step
                if self._t_first_step is not None else 0.0)
        s["wall_s"] = wall
        s["tokens_per_s"] = (self._stats["tokens_emitted"] / wall
                             if wall > 0 else 0.0)
        steps = self._stats["decode_steps"]
        s["mean_step_ms"] = (self._stats["step_time_ns"] / steps / 1e6
                             if steps else 0.0)
        s["mean_batch"] = (self._stats["tokens_emitted"] / steps
                           if steps else 0.0)
        if self._stats["draft_proposed"]:
            s["draft_acceptance"] = (self._stats["draft_accepted"]
                                     / self._stats["draft_proposed"])
        if self.spec_tokens > 0:
            s["draft_source"] = ("model" if self.draft_cache is not None
                                 else "ngram")
        return s
