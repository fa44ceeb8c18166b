"""GPT-2 byte-level BPE tokenizer.

A pure-Python copy of ``backpacks_flash_attn_tpu/utils/tokenizer.py``: the
algorithm of the canonical GPT-2 ``encoder.py`` (Radford et al. 2019) over
the released ``vocab.json`` + ``merges.txt``, with byte-identical token ids
and no network, plus ``train_toy`` for small vocabularies trained here.

Usage:
    tok = GPT2Tokenizer.from_files("vocab.json", "merges.txt")
    ids = tok(" hello world")["input_ids"]
    text = tok.decode(ids)

The __call__ returns {'input_ids': [...]} so it is drop-in for every
tokenizer-consuming API in this package (eval/similarity.py etc.).
"""

from __future__ import annotations

import functools
import json
from typing import Dict, Iterable, List, Tuple

try:
    import regex as _re
    _PAT = _re.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
        r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
except ImportError:  # fall back to a close re approximation
    import re as _re
    _PAT = _re.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\w+| ?[^\s\w]+|\s+(?!\S)|\s+""")

EOT = "<|endoftext|>"


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode table (the trick that
    makes BPE operate on visible characters while covering all bytes)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class GPT2Tokenizer:
    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]]):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, List[str]] = {}
        self.eos_token = EOT
        self.eos_token_id = self.encoder.get(EOT)

    # ------------------------------------------------------------- loading

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str) -> "GPT2Tokenizer":
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                if i == 0 and line.startswith("#"):
                    continue
                parts = line.rstrip("\n").split(" ")
                if len(parts) == 2:
                    merges.append((parts[0], parts[1]))
        return cls(vocab, merges)

    @classmethod
    def train_toy(cls, corpus: Iterable[str], vocab_size: int
                  ) -> "GPT2Tokenizer":
        """Train a small BPE from scratch (for tests/demos — the real GPT-2
        files are the production path). Standard greedy pair-merge training
        over byte-unicode symbols."""
        be = bytes_to_unicode()
        words: Dict[Tuple[str, ...], int] = {}
        for text in corpus:
            for m in _PAT.findall(text):
                sym = tuple(be[b] for b in m.encode("utf-8"))
                words[sym] = words.get(sym, 0) + 1
        vocab = {c: i for i, c in enumerate(sorted(set(be.values())))}
        merges: List[Tuple[str, str]] = []
        while len(vocab) + 1 < vocab_size:
            counts: Dict[Tuple[str, str], int] = {}
            for w, n in words.items():
                for p in zip(w, w[1:]):
                    counts[p] = counts.get(p, 0) + n
            if not counts:
                break
            best = max(counts, key=lambda p: (counts[p], p))
            if counts[best] < 2:
                break
            merges.append(best)
            joined = "".join(best)
            vocab[joined] = len(vocab)
            new_words = {}
            for w, n in words.items():
                out, i = [], 0
                while i < len(w):
                    if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                        out.append(joined)
                        i += 2
                    else:
                        out.append(w[i])
                        i += 1
                new_words[tuple(out)] = new_words.get(tuple(out), 0) + n
            words = new_words
        vocab[EOT] = len(vocab)
        return cls(vocab, merges)

    # ------------------------------------------------------------- encode

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        pairs = _get_pairs(word)
        while pairs:
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            first, second = best
            out: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    out.extend(word[i:])
                    break
                out.extend(word[i:j])
                if j < len(word) - 1 and word[j + 1] == second:
                    out.append(first + second)
                    i = j + 2
                else:
                    out.append(word[j])
                    i = j + 1
            word = tuple(out)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        self._cache[token] = list(word)
        return self._cache[token]

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for m in _PAT.findall(text):
            sym = "".join(self.byte_encoder[b] for b in m.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(sym))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        # every vocab string is a byte-unicode sequence (<|endoftext|> is
        # plain ASCII, which the byte table covers), so this is total
        data = bytes(self.byte_decoder[c] for c in text)
        return data.decode("utf-8", errors="replace")

    def __call__(self, text: str) -> Dict[str, List[int]]:
        return {"input_ids": self.encode(text)}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)
