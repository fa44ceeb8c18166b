"""PPLM (Plug-and-Play LM) baseline: gradient-steered decoding.

Port of ``backpacks_flash_attn_tpu/eval/pplm.py`` (reference:
training/run_pplm.py:96-266): at each decode step, perturb the GPT's past
keys/values by gradient ascent on a bag-of-words attribute loss of the
next-token distribution, anchored by a KL term against the unperturbed
distribution, with per-tensor gradient-norm normalization; then emit from
the geometric fusion p_pert^gm * p_unpert^(1-gm). The reference's
decay-window mask over past positions is approximated, as in JAX, by
perturbing only the last ``window`` positions.

The gradient forwards run the plain attention (see :func:`perturb_cache`);
every forward-only step (the unperturbed distribution, the final perturbed
and unperturbed next-token distributions, the real cache's advance) runs
the decode kernel (K1), and the prompt's prefill the flash kernel (K3).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import GPTConfig
from ..models import gpt as gpt_lib
from ..ops import _build
from ..utils import prng

EPS = 1e-10


def _next_token_logprobs(params, cfg, token, cache) -> torch.Tensor:
    """log p(next | cache, token) (b, V) f32, leaving ``cache`` as it was:
    the forward writes the token's keys/values one column past the cache's
    length (into the cache's own tensors, which the real advance writes
    again with the same values), on a view whose length advances."""
    view = gpt_lib.KVCache(k=cache.k, v=cache.v, length=cache.length,
                           k_scale=cache.k_scale, v_scale=cache.v_scale)
    hidden, _ = gpt_lib.gpt_forward_with_cache(params, cfg, token, view)
    logits = gpt_lib.lm_logits(params, cfg, hidden)[:, -1]
    return torch.log_softmax(logits.float(), dim=-1)


def _live(cache, window: Optional[int]) -> torch.Tensor:
    """(S,) f32: 1 at the positions the delta perturbs."""
    pos = torch.arange(cache.k.shape[-1], device=cache.k.device)
    live = pos < cache.length
    if window is not None:
        live = live & (pos >= cache.length - window)
    return live.float()


class _Layers:
    """A stacked cache tensor (L, ...) held as L separate tensors, for the
    gradient forwards: the forward writes each layer's new column in place,
    and a write into one stacked tensor would bump the version of the view
    the previous layer's attention saved for the backward. Indexing as the
    forward indexes a cache (``[li]``, ``[li, ...]``), shape and dtype."""

    def __init__(self, layers):
        self.layers = layers
        self.dtype = layers[0].dtype
        self.shape = torch.Size((len(layers), *layers[0].shape))

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            return self.layers[idx[0]][idx[1:]]
        return self.layers[idx]


def _perturbed(cache, dk, dv, live, stacked: bool = True) -> gpt_lib.KVCache:
    """A new cache: k + dk and v + dv over the live positions (JAX :66),
    in the cache's dtype; ``stacked=False`` keeps the layers apart
    (:class:`_Layers`)."""
    ks = [(cache.k[i].float() + dk[i] * live[None, None, :]).to(cache.k.dtype)
          for i in range(cache.k.shape[0])]
    vs = [(cache.v[i].float() + dv[i] * live[None, :, None]).to(cache.v.dtype)
          for i in range(cache.v.shape[0])]
    if stacked:
        return gpt_lib.KVCache(k=torch.stack(ks), v=torch.stack(vs),
                               length=cache.length)
    return gpt_lib.KVCache(k=_Layers(ks), v=_Layers(vs), length=cache.length)


def perturb_cache(params, cfg: GPTConfig, cache, token: torch.Tensor,
                  bow_vec: torch.Tensor, *, stepsize: float = 0.02,
                  num_iterations: int = 3, kl_scale: float = 0.01,
                  window: Optional[int] = None):
    """Gradient-ascend a (dk, dv) delta on the cache toward the bag-of-words
    loss  -log sum_{w in BoW} p(w | past + delta)  + kl_scale * KL(p || p0)
    (JAX :42). Returns the perturbed cache (new tensors; ``cache`` is left
    as it was). Floating-point caches only."""
    if cache.k_scale is not None:
        raise ValueError("PPLM perturbs floating-point caches")
    with torch.no_grad():
        logp0 = _next_token_logprobs(params, cfg, token, cache)
    live = _live(cache, window)
    bow = bow_vec.float()[None, :]
    dk = torch.zeros(cache.k.shape, dtype=torch.float32, device=cache.k.device)
    dv = torch.zeros(cache.v.shape, dtype=torch.float32, device=cache.v.device)
    for _ in range(num_iterations):
        dk.requires_grad_(True)
        dv.requires_grad_(True)
        # The gradient runs through the attention, and the decode kernel (K1)
        # has no backward (the JAX package's has none either: jax.grad runs
        # its XLA decode contraction, use_pallas=False, models/gpt.py:998).
        # So these forwards take the plain attention, as JAX takes XLA here.
        with torch.enable_grad(), _build.plain_path():
            logp = _next_token_logprobs(
                params, cfg, token, _perturbed(cache, dk, dv, live, False))
            p = logp.exp()
            bow_loss = -torch.log((p * bow).sum(-1) + EPS)
            kl = (p * (logp - logp0)).sum(-1)
            loss = (bow_loss + kl_scale * kl).mean()
            gk, gv = torch.autograd.grad(loss, (dk, dv))
        with torch.no_grad():
            # per-tensor grad-norm normalization (run_pplm.py:217-224); a
            # vanishing gradient (an empty BoW) is dropped instead of
            # amplified into an O(stepsize) push of pure noise (JAX :77-80)
            new = []
            for d, g in ((dk, gk), (dv, gv)):
                n = torch.linalg.vector_norm(g)
                new.append(torch.where(n > 1e-6, d - stepsize * g / (n + EPS),
                                       d))
            dk, dv = new
    with torch.no_grad():
        return _perturbed(cache, dk, dv, live)


@torch.no_grad()
def pplm_generate(params, cfg: GPTConfig, prompt_ids, bow_ids: Sequence[int],
                  *, max_new_tokens: int = 20, stepsize: float = 0.02,
                  num_iterations: int = 3, kl_scale: float = 0.01,
                  gm_scale: float = 0.9, temperature: float = 0.0,
                  window: Optional[int] = None,
                  rng: Optional[torch.Tensor] = None,
                  max_seqlen: Optional[int] = None) -> np.ndarray:
    """PPLM decoding loop (JAX :93; reference run_pplm.py:389-560): per
    step, perturb the past, fuse the perturbed and unperturbed
    distributions geometrically, emit. ``rng`` is a ``utils.prng`` key
    (sampling at temperature > 0, split per step as JAX splits it).
    The cache lives on the params' device in f32, as in JAX, whatever the
    params' dtype: a step of the perturbation moves each cached value far
    less than a bf16 unit, and the decode steps over an f32 cache run in
    f32. Returns (b, n) ids."""
    dev = params["wte"].device
    prompt_ids = (prompt_ids.to(dev, torch.long)
                  if isinstance(prompt_ids, torch.Tensor) else
                  torch.as_tensor(np.asarray(prompt_ids), dtype=torch.long,
                                  device=dev))
    b, p = prompt_ids.shape
    S = max_seqlen or (p + max_new_tokens + 1)
    bow_vec = torch.zeros((cfg.padded_vocab_size,), dtype=torch.float32,
                          device=dev)
    bow_ids = list(bow_ids)
    if bow_ids:
        bow_vec[torch.as_tensor(bow_ids, dtype=torch.long, device=dev)] = 1.0

    cache = gpt_lib.init_kv_cache(cfg, b, S, torch.float32, device=dev)
    # prefill on all but the last prompt token; the loop perturbs before
    # consuming the last token (the reference's protocol)
    if p > 1:
        gpt_lib.gpt_forward_with_cache(params, cfg, prompt_ids[:, :-1], cache)
    token = prompt_ids[:, -1:]
    out = []
    for _ in range(max_new_tokens):
        pert = perturb_cache(params, cfg, cache, token, bow_vec,
                             stepsize=stepsize, num_iterations=num_iterations,
                             kl_scale=kl_scale, window=window)
        logp_pert = _next_token_logprobs(params, cfg, token, pert)
        logp_unpert = _next_token_logprobs(params, cfg, token, cache)
        # geometric fusion (run_pplm.py:501-510)
        logp = gm_scale * logp_pert + (1.0 - gm_scale) * logp_unpert
        if temperature > 0 and rng is not None:
            rng, sub = prng.split(rng)
            nxt = prng.categorical(sub, logp / temperature)
        else:
            nxt = logp.argmax(dim=-1)
        # advance the REAL (unperturbed) cache with the consumed token
        gpt_lib.gpt_forward_with_cache(params, cfg, token, cache)
        token = nxt[:, None]
        out.append(token[:, 0].cpu().numpy())
    return np.stack(out, axis=1).astype(np.int32)
