"""GPT-2 BPE tokenizer with its merge loop in C++ (``csrc/bpe_tokenizer.cpp``).

Port of ``backpacks_flash_attn_tpu/utils/fast_tokenizer.py``. The serving
path tokenizes on the host, where the pure-Python merge loop
(``tokenizer.py`` ``_bpe``) is the cost; this wrapper keeps Python's regex
pre-split and byte<->unicode tables and moves the merge loop into a C++
library with a per-word cache. Token ids are those of
:class:`GPT2Tokenizer`, bit for bit.

The library is compiled with ``g++`` at first use into ``build/bpe_tokenizer/``
at the root of the checkout (a directory ``.gitignore`` lists), keyed by the
source's content hash, as ``serving/scheduler.py`` builds its scheduler.
Where the build fails the wrapper takes the Python path (``native`` is then
False), as the JAX package's does.

    tok = FastGPT2Tokenizer(GPT2Tokenizer.from_files(vocab, merges))
    ids = tok.encode(" hello world")      # == slow.encode(...)
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import numpy as np

from ..ops import _build
from .tokenizer import _PAT, GPT2Tokenizer

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "bpe_tokenizer.cpp"


def build_native() -> Path:
    """Compile bpe_tokenizer.cpp (once per content hash); returns the
    library path, or raises RuntimeError with the compiler's output."""
    return _build.build_host_library(_SRC, "bpe_tokenizer", "libbptok")


_LIB = None
_LIB_TRIED = False
_I32P = ctypes.POINTER(ctypes.c_int32)


def _lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None where it does not build (JAX :53)."""
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB_TRIED = True
        try:
            lib = ctypes.CDLL(str(build_native()))
        except (RuntimeError, OSError):
            return None
        lib.bptok_new.restype = ctypes.c_void_p
        lib.bptok_new.argtypes = [ctypes.c_char_p, _I32P, _I32P,
                                  ctypes.c_int32, ctypes.c_char_p, _I32P,
                                  ctypes.c_int32]
        lib.bptok_free.argtypes = [ctypes.c_void_p]
        lib.bptok_encode.restype = ctypes.c_int32
        lib.bptok_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     _I32P, ctypes.c_int32, _I32P,
                                     ctypes.c_int32]
        lib.bptok_cache_size.restype = ctypes.c_int32
        lib.bptok_cache_size.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def _pack(chunks: List[bytes]):
    """-> (blob, offsets int32 (n+1,)) for the C side's slice() framing."""
    offsets = np.zeros(len(chunks) + 1, np.int32)
    np.cumsum([len(c) for c in chunks], out=offsets[1:])
    return b"".join(chunks), offsets


class FastGPT2Tokenizer:
    """Drop-in for GPT2Tokenizer with the BPE loop in C++ (see module doc).

    Vocab and merges are converted to raw-byte form once (each byte-unicode
    symbol char maps to one byte via byte_decoder), so the C++ side never
    sees unicode: initial symbols are single bytes of the regex pieces'
    UTF-8 encoding, exactly mirroring tokenizer.py:encode."""

    def __init__(self, slow: GPT2Tokenizer):
        self.slow = slow
        self.eos_token = slow.eos_token
        self.eos_token_id = slow.eos_token_id
        self._handle = None
        lib = _lib()
        if lib is None:
            return
        bd = slow.byte_decoder

        def raw(sym: str) -> bytes:
            return bytes(bd[c] for c in sym)

        toks = [(raw(s), i) for s, i in slow.encoder.items()]
        tok_blob, tok_off = _pack([t for t, _ in toks])
        tok_ids = np.asarray([i for _, i in toks], np.int32)
        merges = sorted(slow.bpe_ranks.items(), key=lambda kv: kv[1])
        merge_blob, merge_off = _pack(
            [raw(s) for pair, _ in merges for s in pair])
        self._handle = lib.bptok_new(
            tok_blob, tok_off.ctypes.data_as(_I32P),
            tok_ids.ctypes.data_as(_I32P), len(toks),
            merge_blob, merge_off.ctypes.data_as(_I32P), len(merges))
        self._lib = lib

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.bptok_free(self._handle)
            self._handle = None

    @property
    def native(self) -> bool:
        return self._handle is not None

    @property
    def cache_entries(self) -> int:
        return self._lib.bptok_cache_size(self._handle) if self.native else 0

    def encode(self, text: str) -> List[int]:
        if not self.native:
            return self.slow.encode(text)
        words = [m.encode("utf-8") for m in _PAT.findall(text)]
        if not words:
            return []
        blob, offsets = _pack(words)
        # merging only ever shrinks the symbol count, so len(blob) bounds it
        out = np.empty(max(len(blob), 1), np.int32)
        n = self._lib.bptok_encode(
            self._handle, blob, offsets.ctypes.data_as(_I32P), len(words),
            out.ctypes.data_as(_I32P), len(out))
        if n < 0:   # unknown symbol (toy vocabs): defer to the Python path
            return self.slow.encode(text)
        return out[:n].tolist()

    def decode(self, ids: Iterable[int]) -> str:
        return self.slow.decode(ids)

    def __call__(self, text: str) -> Dict[str, List[int]]:
        return {"input_ids": self.encode(text)}

    @property
    def vocab_size(self) -> int:
        return self.slow.vocab_size
