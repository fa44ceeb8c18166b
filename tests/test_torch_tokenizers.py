"""The port's tokenizers and corpus preparation against the JAX package's.

``utils/tokenizer.py`` (pure Python), ``utils/fast_tokenizer.py`` (the C++
merge loop of ``csrc/bpe_tokenizer.cpp``, built by g++ into
``build/bpe_tokenizer/``) and ``data/prepare.py`` on vocabulary files the
test writes: ids must equal the JAX package's exactly, and the parallel
corpus equal its ``.npy`` bit for bit.
"""

import json
import random
import shutil
import string

import numpy as np
import pytest

from backpacks_flash_attn_tpu.data import prepare as jprep
from backpacks_flash_attn_tpu.utils import fast_tokenizer as jfast
from backpacks_flash_attn_tpu.utils import tokenizer as jtok
from backpacks_flash_attn_tpu_torch.data import prepare as tprep
from backpacks_flash_attn_tpu_torch.utils import fast_tokenizer as tfast
from backpacks_flash_attn_tpu_torch.utils import tokenizer as ttok

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "hello world, hello tokenizer! it's working.",
    "backpack language models decompose meaning",
    "aaa aab abb bbb abab baba",
    "senses of a word: river bank, money bank, bank shot",
]
TEXTS = CORPUS + [
    "", " ", "unseen-Words; punct!!! 12345", "newlines\nand\ttabs",
    "café naïve über", "日本語 \U0001f600", "it's we've they'll can't i'm",
]


def _fuzz(n=40, seed=0):
    rng = random.Random(seed)
    alphabet = string.ascii_letters + string.digits + " .,'!?\n\t" + "éü"
    return ["".join(rng.choice(alphabet) for _ in range(rng.randrange(0, 80)))
            for _ in range(n)]


def _write(tok, tmp_path):
    """vocab.json / merges.txt of a trained tokenizer, in GPT-2's format."""
    vocab, merges = tmp_path / "vocab.json", tmp_path / "merges.txt"
    vocab.write_text(json.dumps(tok.encoder), encoding="utf-8")
    ranked = sorted(tok.bpe_ranks.items(), key=lambda kv: kv[1])
    merges.write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for (a, b), _ in ranked),
                      encoding="utf-8")
    return str(vocab), str(merges)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tok = jtok.GPT2Tokenizer.train_toy(CORPUS * 4, vocab_size=400)
    return _write(tok, tmp_path_factory.mktemp("tok"))


def test_train_toy_and_byte_table_match_jax():
    assert ttok.bytes_to_unicode() == jtok.bytes_to_unicode()
    t = ttok.GPT2Tokenizer.train_toy(CORPUS * 4, vocab_size=400)
    j = jtok.GPT2Tokenizer.train_toy(CORPUS * 4, vocab_size=400)
    assert t.encoder == j.encoder
    assert t.bpe_ranks == j.bpe_ranks
    assert t.eos_token_id == j.eos_token_id == len(t.encoder) - 1


def test_slow_and_native_ids_equal_jax(files):
    jslow = jtok.GPT2Tokenizer.from_files(*files)
    tslow = ttok.GPT2Tokenizer.from_files(*files)
    tfast_ = tfast.FastGPT2Tokenizer(ttok.GPT2Tokenizer.from_files(*files))
    jfast_ = jfast.FastGPT2Tokenizer(jtok.GPT2Tokenizer.from_files(*files))
    for text in TEXTS + _fuzz():
        want = jslow.encode(text)
        assert tslow.encode(text) == want, repr(text)
        assert tfast_.encode(text) == want, repr(text)
        assert jfast_.encode(text) == want, repr(text)
        assert tfast_.decode(want) == jslow.decode(want)
    assert tfast_("hello")["input_ids"] == jslow("hello")["input_ids"]
    assert tfast_.vocab_size == jslow.vocab_size
    assert tfast_.eos_token_id == jslow.eos_token_id


def test_native_builds_into_the_checkout(files):
    """With g++ the C++ library builds under build/bpe_tokenizer/ and the
    wrapper is native; its word cache grows and stays right."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    path = tfast.build_native()
    assert path.parent.name == "bpe_tokenizer" and path.parent.parent.name == "build"
    slow = ttok.GPT2Tokenizer.from_files(*files)
    fast = tfast.FastGPT2Tokenizer(slow)
    assert fast.native
    before = fast.cache_entries
    text = "zqxj vvkp wmbr"
    first = fast.encode(text)
    assert fast.cache_entries > before
    assert fast.encode(text) == first == slow.encode(text)


def test_encode_corpus_parallel_equals_jax(files, tmp_path):
    docs = (CORPUS + _fuzz(30, seed=1)) * 3
    jout = jprep.encode_corpus_parallel(
        docs, str(tmp_path / "j.npy"),
        tokenizer_factory=jprep.native_tokenizer_factory(*files), eos_id=7,
        num_workers=0)
    serial = tprep.encode_corpus_parallel(
        docs, str(tmp_path / "s.npy"),
        tokenizer_factory=tprep.native_tokenizer_factory(*files), eos_id=7,
        num_workers=0)
    parallel = tprep.encode_corpus_parallel(
        docs, str(tmp_path / "p.npy"),
        tokenizer_factory=tprep.native_tokenizer_factory(*files), eos_id=7,
        num_workers=2, chunk_docs=40)
    assert jout.dtype == serial.dtype == parallel.dtype == np.uint16
    np.testing.assert_array_equal(np.asarray(serial), np.asarray(jout))
    np.testing.assert_array_equal(np.asarray(parallel), np.asarray(jout))


def test_prepare_cli_text_file(files, tmp_path, capsys):
    docs = tmp_path / "docs.txt"
    docs.write_text("\n".join(CORPUS * 2) + "\n", encoding="utf-8")
    vocab, merges = files
    tprep.main(["--text-file", str(docs), "--out", str(tmp_path / "t.npy"),
                "--vocab", vocab, "--merges", merges, "--workers", "0"])
    jprep.main(["--text-file", str(docs), "--out", str(tmp_path / "j.npy"),
                "--vocab", vocab, "--merges", merges, "--workers", "0"])
    assert "prepared" in capsys.readouterr().out
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"),
                                  np.load(tmp_path / "j.npy"))
    # prepare_hf_dataset: an existing cache short-circuits the load (no
    # datasets call, no network)
    from backpacks_flash_attn_tpu_torch.data import lm_dataset as lmd
    cached = lmd.save_corpus(np.arange(10, dtype=np.uint16), str(tmp_path), "owt")
    got = tprep.prepare_hf_dataset("openwebtext", cache_dir=str(tmp_path),
                                   tag="owt")
    assert cached == lmd.cache_path(str(tmp_path), "owt")
    np.testing.assert_array_equal(np.asarray(got), np.arange(10))
