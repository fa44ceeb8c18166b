"""Parallel corpus preparation: multiprocess tokenize -> concat -> memmap.

Port of ``backpacks_flash_attn_tpu/data/prepare.py`` (host-only: numpy and
the tokenizers, no device). The OWT-scale analogue of the reference's
datamodule prepare step (training/src/datamodules/language_modeling_hf.py:
154-229), in two phases against the plain ``encode_corpus`` contract
(lm_dataset.py), the final array on disk as .npy (np.memmap):

  phase 1  workers tokenize document chunks and spill per-chunk .npy parts,
           returning only lengths (no token pickling through the pipe);
  phase 2  workers copy their parts into the right offsets of ONE
           preallocated output memmap (parallel writers).

`prepare_hf_dataset` adapts a HuggingFace dataset split end-to-end
(load -> parallel tokenize -> cached .npy), availability-gated so the
module imports fine without `datasets`/network.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Optional, Sequence

import numpy as np

from .lm_dataset import EOS_GPT2, cache_path, encode_corpus

# pool workers build their tokenizer once via the initializer (HF fast
# tokenizers are expensive to pickle per task)
_WORKER_TOKENIZER = None
_WORKER_EOS = EOS_GPT2
_WORKER_DTYPE = np.uint16
_WORKER_DIR = ""


def _init_worker(tokenizer_factory, eos_id, dtype_name, tmpdir):
    global _WORKER_TOKENIZER, _WORKER_EOS, _WORKER_DTYPE, _WORKER_DIR
    _WORKER_TOKENIZER = tokenizer_factory() if tokenizer_factory else None
    _WORKER_EOS = eos_id
    _WORKER_DTYPE = np.dtype(dtype_name)
    _WORKER_DIR = tmpdir


def _tokenize_part(job):
    """Phase 1: tokenize one chunk of documents, spill ids to a part file."""
    part_idx, texts = job
    ids = encode_corpus(texts, _WORKER_TOKENIZER, eos_id=_WORKER_EOS,
                        dtype=_WORKER_DTYPE)
    np.save(os.path.join(_WORKER_DIR, f"part_{part_idx}.npy"), ids)
    return part_idx, len(ids)


def _build_native_tokenizer(vocab_path, merges_path):
    from ..utils.fast_tokenizer import FastGPT2Tokenizer
    from ..utils.tokenizer import GPT2Tokenizer
    return FastGPT2Tokenizer(GPT2Tokenizer.from_files(vocab_path,
                                                      merges_path))


def native_tokenizer_factory(vocab_path: str, merges_path: str) -> Callable:
    """Picklable factory for the offline native tokenizer (C++ BPE merge
    loop, utils/fast_tokenizer.py) — OWT-scale prep with no HF hub access:

        prepare_corpus(texts, out,
                       tokenizer_factory=native_tokenizer_factory(v, m))
    """
    import functools
    return functools.partial(_build_native_tokenizer, vocab_path, merges_path)


def default_gpt2_tokenizer():
    """Module-level (spawn-picklable) factory for the stock GPT-2 tokenizer."""
    from transformers import GPT2TokenizerFast
    return GPT2TokenizerFast.from_pretrained("gpt2")


def _copy_part(job):
    """Phase 2: copy one part into its offset of the shared output memmap."""
    part_idx, offset, length, out_path = job
    part = np.load(os.path.join(_WORKER_DIR, f"part_{part_idx}.npy"),
                   mmap_mode="r")
    out = np.load(out_path, mmap_mode="r+")
    out[offset:offset + length] = part
    out.flush()
    return part_idx


def encode_corpus_parallel(texts: Sequence[str], out_path: str, *,
                           tokenizer_factory: Optional[Callable] = None,
                           eos_id: int = EOS_GPT2, dtype=np.uint16,
                           num_workers: int = 0,
                           chunk_docs: int = 1024) -> np.ndarray:
    """Tokenize `texts` across `num_workers` processes and write the flat
    EOS-joined token array to `out_path` (.npy). Returns it memory-mapped.

    tokenizer_factory: zero-arg callable building the tokenizer INSIDE each
    worker (None = texts are already id sequences). num_workers=0 runs the
    sequential `encode_corpus` path (identical output — tested)."""
    if num_workers <= 0:
        tok = tokenizer_factory() if tokenizer_factory else None
        ids = encode_corpus(texts, tok, eos_id=eos_id, dtype=dtype)
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        np.save(out_path, ids)
        return np.load(out_path, mmap_mode="r")

    import multiprocessing as mp
    texts = list(texts)
    chunks = [(i, texts[lo:lo + chunk_docs])
              for i, lo in enumerate(range(0, len(texts), chunk_docs))]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    ctx = mp.get_context("spawn")   # fork is unsafe under a live CUDA context
    with tempfile.TemporaryDirectory(prefix="lm_parts_") as tmpdir:
        with ctx.Pool(num_workers, initializer=_init_worker,
                      initargs=(tokenizer_factory, eos_id, np.dtype(dtype).name,
                                tmpdir)) as pool:
            lengths = dict(pool.map(_tokenize_part, chunks))
            total = sum(lengths.values())
            out = np.lib.format.open_memmap(
                out_path, mode="w+", dtype=np.dtype(dtype), shape=(total,))
            del out  # header written; workers reopen r+
            offsets, off = {}, 0
            for i in sorted(lengths):
                offsets[i] = off
                off += lengths[i]
            pool.map(_copy_part,
                     [(i, offsets[i], lengths[i], out_path)
                      for i in sorted(lengths)])
    return np.load(out_path, mmap_mode="r")


def prepare_hf_dataset(dataset_name: str, *, cache_dir: str, tag: str,
                       split: str = "train", text_column: str = "text",
                       dataset_config: Optional[str] = None,
                       tokenizer_factory: Optional[Callable] = None,
                       eos_id: int = EOS_GPT2, dtype=np.uint16,
                       num_workers: int = 8,
                       chunk_docs: int = 1024) -> np.ndarray:
    """Load a HuggingFace dataset split and prepare it into the cached flat
    .npy corpus (reference language_modeling_hf.py:80-95 prepare_data). The
    cache is keyed by `tag`; an existing cache short-circuits everything.
    Requires the `datasets` package (and network for remote datasets) —
    raises ImportError with guidance when unavailable."""
    path = cache_path(cache_dir, tag)
    if os.path.exists(path):
        return np.load(path, mmap_mode="r")
    try:
        import datasets  # noqa: F401  availability gate
    except ImportError as e:   # pragma: no cover - env without datasets
        raise ImportError(
            "prepare_hf_dataset needs the 'datasets' package; tokenize your "
            "corpus with encode_corpus_parallel instead") from e
    ds = datasets.load_dataset(dataset_name, dataset_config, split=split)
    if tokenizer_factory is None:
        tokenizer_factory = default_gpt2_tokenizer
    return encode_corpus_parallel(
        ds[text_column], path, tokenizer_factory=tokenizer_factory,
        eos_id=eos_id, dtype=dtype, num_workers=num_workers,
        chunk_docs=chunk_docs)


def main(argv=None) -> None:
    """CLI: prepare a flat token corpus (reference prepare_data entry,
    language_modeling_hf.py:80-95).

        python -m backpacks_flash_attn_tpu_torch.data.prepare \
            --text-file docs.txt --out corpus.npy \
            [--vocab vocab.json --merges merges.txt] [--workers 8]
        python -m backpacks_flash_attn_tpu_torch.data.prepare \
            --dataset openwebtext --cache-dir data --tag owt   # needs hub
    """
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--text-file",
                   help="local newline-delimited documents (offline path)")
    p.add_argument("--out", help="output .npy (required with --text-file)")
    p.add_argument("--dataset", help="HF dataset name (network-gated)")
    p.add_argument("--dataset-config", default=None)
    p.add_argument("--split", default="train")
    p.add_argument("--text-column", default="text")
    p.add_argument("--cache-dir", default="data")
    p.add_argument("--tag", default=None)
    p.add_argument("--vocab", help="vocab.json for the offline native BPE")
    p.add_argument("--merges", help="merges.txt for the offline native BPE")
    p.add_argument("--eos-id", type=int, default=EOS_GPT2)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--chunk-docs", type=int, default=1024)
    a = p.parse_args(argv)
    if bool(a.text_file) == bool(a.dataset):
        p.error("exactly one of --text-file / --dataset")

    factory = (native_tokenizer_factory(a.vocab, a.merges)
               if a.vocab and a.merges else None)
    if a.text_file:
        if not a.out:
            p.error("--out is required with --text-file")
        if factory is None:
            p.error("--text-file needs --vocab/--merges (raw text must be "
                    "tokenized; without them texts are treated as id lists)")
        with open(a.text_file, encoding="utf-8") as f:
            texts = [line.rstrip("\n") for line in f if line.strip()]
        toks = encode_corpus_parallel(
            texts, a.out, tokenizer_factory=factory, eos_id=a.eos_id,
            num_workers=a.workers, chunk_docs=a.chunk_docs)
        print(f"{a.out}: {len(toks):,} tokens from {len(texts):,} documents")
    else:
        toks = prepare_hf_dataset(
            a.dataset, cache_dir=a.cache_dir, tag=a.tag or a.dataset,
            split=a.split, text_column=a.text_column,
            dataset_config=a.dataset_config, tokenizer_factory=factory,
            eos_id=a.eos_id, num_workers=a.workers, chunk_docs=a.chunk_docs)
    print(f"prepared {len(toks):,} tokens")


if __name__ == "__main__":
    main()
