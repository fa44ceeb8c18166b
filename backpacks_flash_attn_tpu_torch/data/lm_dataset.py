"""Language-modeling data pipeline: tokenize -> concat -> chunk, with
fault-tolerant deterministic iteration.

A numpy-only copy of ``backpacks_flash_attn_tpu/data/lm_dataset.py`` (the
port imports nothing of the JAX package): the same corpus format, examples,
batches and resumable sampler state, so both packages read one corpus in
the same order. Its notes on the reference pipeline follow.

Re-design of the reference pipeline
(reference: training/src/datamodules/language_modeling_hf.py:154-251,
training/src/datamodules/datasets/lm_dataset.py:10-32,
training/src/datamodules/fault_tolerant_sampler.py:10-121):

  * the corpus is ONE flat uint16/uint32 token array (all docs concatenated,
    EOS appended per doc), cached as .npy and opened with np.memmap
  * example i = tokens[i*L : i*L + L + 1], split into (input, target) — no
    padding, no overlap (lm_dataset.py:24-32)
  * iteration order is a seeded per-epoch permutation with an explicit
    counter, so training resumes at the exact batch after preemption
    (FaultTolerantDistributedSampler semantics, fault_tolerant_sampler.py:
    66-121) — but as a pure state value (epoch, counter, seed) instead of
    RNG-object pickling
  * multi-host sharding = rank strides over the permutation, same as the
    reference's DistributedSampler contract

Batches are always full (static shapes): the permutation is
truncated to a multiple of batch_size x num_shards (the reference pads with
repeated indices instead; for LM pretraining truncation is the standard
choice and keeps every batch identically shaped).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Sequence, Tuple

import numpy as np

EOS_GPT2 = 50256


# ----------------------------------------------------------------- corpus

def encode_corpus(texts: Sequence[str], tokenizer=None,
                  eos_id: int = EOS_GPT2, dtype=np.uint16) -> np.ndarray:
    """Tokenize and concatenate documents into one flat token array with EOS
    appended to each doc (reference language_modeling_hf.py:154-170). With
    tokenizer=None, texts must already be sequences of ids."""
    chunks = []
    for t in texts:
        ids = (tokenizer(t)["input_ids"] if tokenizer is not None else list(t))
        ids.append(eos_id)
        chunks.append(np.asarray(ids, dtype))
    return np.concatenate(chunks) if chunks else np.zeros((0,), dtype)


def cache_path(cache_dir: str, tag: str) -> str:
    return os.path.join(cache_dir, f"lm_corpus_{tag}.npy")


def save_corpus(tokens: np.ndarray, cache_dir: str, tag: str) -> str:
    """Write the flat token array as .npy for memmap reopening (the reference
    caches to .npy keyed by tokenizer/val-ratio/seed,
    language_modeling_hf.py:249-251)."""
    os.makedirs(cache_dir, exist_ok=True)
    path = cache_path(cache_dir, tag)
    np.save(path, tokens)
    return path


def load_corpus(path: str) -> np.ndarray:
    """Memory-mapped corpus: no RAM copy, page-cache backed (the TPU-host
    analogue of the reference's shared-memory array,
    language_modeling_hf.py:186-229)."""
    return np.load(path, mmap_mode="r")


# ----------------------------------------------------------------- dataset

class LMDataset:
    """Chunked LM dataset over a flat token array
    (reference lm_dataset.py:10-32): item i = tokens[i*L : i*L+L+1] split into
    (x, y); the trailing partial chunk is dropped."""

    def __init__(self, tokens: np.ndarray, seqlen: int):
        self.tokens = tokens
        self.seqlen = seqlen

    def __len__(self) -> int:
        return max(0, (len(self.tokens) - 1) // self.seqlen)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        L = self.seqlen
        window = np.asarray(self.tokens[i * L: i * L + L + 1], np.int64)
        return window[:-1].astype(np.int32), window[1:].astype(np.int32)

    def batch(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Gather a batch of examples: (b, L) inputs and targets."""
        L = self.seqlen
        starts = np.asarray(indices, np.int64) * L
        window = np.stack([np.asarray(self.tokens[s: s + L + 1], np.int64)
                           for s in starts])
        return window[:, :-1].astype(np.int32), window[:, 1:].astype(np.int32)


# ------------------------------------------------------- fault-tolerant iter

@dataclasses.dataclass
class SamplerState:
    """Resumable iteration state (reference FaultTolerantDistributedSampler
    saves {epoch, counter}, fault_tolerant_sampler.py:94-121)."""
    seed: int = 0
    epoch: int = 0
    counter: int = 0   # examples already consumed this epoch (this shard)


def _epoch_permutation(n: int, seed: int, epoch: int,
                       shuffle: bool) -> np.ndarray:
    if not shuffle:
        return np.arange(n)
    return np.random.default_rng(
        np.random.SeedSequence([seed, epoch])).permutation(n)


def epoch_batches(dataset: LMDataset, batch_size: int,
                  state: SamplerState, *, shuffle: bool = True,
                  shard: int = 0, num_shards: int = 1
                  ) -> Iterator[Tuple[Tuple[np.ndarray, np.ndarray],
                                      SamplerState]]:
    """Yield ((x, y), next_state) for the remainder of state.epoch, starting
    at state.counter — byte-identical continuation after preemption. Shards
    stride the permutation (DistributedSampler layout); the tail that doesn't
    fill batch_size * num_shards is dropped for static shapes."""
    n = len(dataset)
    perm = _epoch_permutation(n, state.seed, state.epoch, shuffle)
    per_shard = (n // (batch_size * num_shards)) * batch_size
    mine = perm[shard::num_shards][:per_shard]
    pos = state.counter
    while pos + batch_size <= per_shard:
        idx = mine[pos: pos + batch_size]
        pos += batch_size
        nxt = SamplerState(seed=state.seed, epoch=state.epoch, counter=pos)
        yield dataset.batch(idx), nxt


def batches(dataset: LMDataset, batch_size: int, state: SamplerState, *,
            shuffle: bool = True, shard: int = 0, num_shards: int = 1
            ) -> Iterator[Tuple[Tuple[np.ndarray, np.ndarray], SamplerState]]:
    """Endless epoch-rolling batch stream resuming from `state`."""
    while True:
        got = False
        for item, nxt in epoch_batches(dataset, batch_size, state,
                                       shuffle=shuffle, shard=shard,
                                       num_shards=num_shards):
            got = True
            yield item, nxt
        state = SamplerState(seed=state.seed, epoch=state.epoch + 1, counter=0)
        if not got:
            raise ValueError("dataset too small for one batch")
