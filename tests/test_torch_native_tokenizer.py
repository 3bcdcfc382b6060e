"""The port's native (C++) tokenizer engine and Q4 repack (CPU): the C++
merge loop against the pure-Python one and the JAX package's tokenizer,
ids past the vocabulary, the repack against the numpy repacks of both
packages and against the JAX package's own C++ repack, and the build
(two processes from a clean directory, a failing compile, no g++).

Tolerance: equal ids and equal bytes.  Skips only where g++ is missing.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from lmrs_tpu.quant import q4_file_to_runtime_np as jax_q4_file_to_runtime_np
from lmrs_tpu.tokenizer import Tokenizer as JaxTokenizer

import lmrs_tpu_torch.native as native
from lmrs_tpu_torch.quant import q4_file_to_runtime_np
from lmrs_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PIECES = {
    "h": 0.1, "e": 0.1, "l": 0.1, "o": 0.1, " ": 0.1, "w": 0.1, "r": 0.1,
    "d": 0.1, "he": 1.0, "ll": 2.0, "llo": 3.0, "hello": 5.0, " w": 1.5,
    "or": 1.2, "ld": 1.1, "orld": 2.5, "world": 4.0, " world": 4.5,
    "é": 0.3, "lo": 2.0, "ol": 2.0, "oo": 0.5, "ooo": 0.5, "dd": -1.0}


@pytest.fixture(autouse=True)
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native engine cannot build")


def toy_vocab():
    vocab = ["<pad>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    scores = [0.0] * len(vocab)
    for piece, score in PIECES.items():
        vocab.append(piece)
        scores.append(score)
    # a repeated text: the lowest id wins the lookup in both engines
    vocab.append("hello")
    scores.append(9.0)
    return vocab, scores


def seeded_texts(n=40, seed=0):
    rng = np.random.default_rng(seed)
    alphabet = list("helowrd éx") + ["hello", " world", "ll", "你"]
    return ["".join(rng.choice(alphabet, size=rng.integers(1, 60)))
            for _ in range(n)]


def test_native_merge_equals_the_python_merge_and_jax():
    vocab, scores = toy_vocab()
    tok = Tokenizer(vocab, scores, 1, 2)
    plain = Tokenizer(vocab, scores, 1, 2, native=False)
    assert tok._native is not None and plain._native is None
    jax_tok = JaxTokenizer(vocab, scores, 1, 2)
    for text in ["hello world", "hello", "wordword hello", "é hello",
                 "w o r l d", "hello world " * 50] + seeded_texts():
        want = plain.encode(text)
        assert tok.encode(text) == want, text
        assert jax_tok.encode(text) == want, text
    for text in seeded_texts(seed=1):
        ids = plain.encode(text, bos=True, eos=True)
        assert tok.encode(text, bos=True, eos=True) == ids


def test_native_engine_sees_the_container_bytes(tmp_path):
    vocab, scores = toy_vocab()
    tok = Tokenizer(vocab, scores, 1, 2)
    tok.save(str(tmp_path / "tok.bin"))
    assert tok._serialize() == (tmp_path / "tok.bin").read_bytes()
    back = Tokenizer.from_file(str(tmp_path / "tok.bin"))
    assert back._native is not None
    assert Tokenizer.from_file(str(tmp_path / "tok.bin"),
                               native=False)._native is None
    # the repeated "hello": the lowest id wins, as in the Python lookup
    assert back.encode("hello") == [vocab.index("hello")]
    assert back.encode("hello world") == tok._merge_plain(
        [back._lookup[c] for c in "hello world"])


def test_native_passes_ids_past_the_vocabulary():
    vocab, scores = toy_vocab()
    tok = Tokenizer(vocab, scores, 1, 2)
    h, e = tok._lookup["h"], tok._lookup["e"]
    for ids in ([999999, h, e, 888888], [h, len(vocab), e], [len(vocab)],
                [], [h, e, h, e, 2 ** 32 - 1]):
        assert tok._merge(ids) == tok._merge_plain(ids)
    with pytest.raises(ValueError):
        tok._merge([h, -1])


def _jax_native_repack(tmp_path):
    """The JAX package's own C++ repack, compiled from its source."""
    lib = tmp_path / "libjax_native.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o",
                    str(lib), str(REPO / "lmrs_tpu/native/tokenizer.cpp")],
                   check=True, capture_output=True, timeout=300)
    cdll = ctypes.CDLL(str(lib))
    cdll.lmrs_q4_repack.restype = None
    cdll.lmrs_q4_repack.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_uint64, ctypes.c_uint32]

    def repack(src, gs):
        dst = np.empty_like(src)
        cdll.lmrs_q4_repack(src.ctypes.data_as(ctypes.c_void_p),
                            dst.ctypes.data_as(ctypes.c_void_p), src.size,
                            gs)
        return dst
    return repack


def test_native_q4_repack_matches_numpy_and_jax(tmp_path):
    jax_repack = _jax_native_repack(tmp_path)
    rng = np.random.default_rng(1)
    for gs in (16, 32, 64, 128):
        src = rng.integers(0, 256, (32, 4 * gs // 2), dtype=np.uint8)
        got = native.q4_repack(src, gs)
        assert got.shape == src.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, q4_file_to_runtime_np(src, gs))
        np.testing.assert_array_equal(got,
                                      jax_q4_file_to_runtime_np(src, gs))
        np.testing.assert_array_equal(got, jax_repack(src, gs))
    with pytest.raises(ValueError):
        native.q4_repack(np.zeros(24, np.uint8), 32)


def test_two_processes_build_from_a_clean_directory_at_once(tmp_path):
    code = ("import sys, pathlib\n"
            "import lmrs_tpu_torch.native as n\n"
            "lib = n.build(pathlib.Path(sys.argv[1]))\n"
            "n.bind(lib).lmrs_tok_free(None)\n"
            "print(lib)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    libs = {o.strip() for o, _ in outs}
    assert len(libs) == 1
    built = list(tmp_path.glob("*/*"))
    assert sorted(p.name for p in built) == [native.LIB_NAME, "lock"]


def test_a_failing_compile_raises_with_the_compiler_output(tmp_path,
                                                           monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="error"):
        native.build(tmp_path / "build")
    assert not list((tmp_path / "build").glob("*/*.so*"))


def test_without_gxx_the_tokenizer_keeps_the_python_loop(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    vocab, scores = toy_vocab()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tok = Tokenizer(vocab, scores, 1, 2)
    assert tok._native is None
    assert [str(w.message) for w in caught
            if issubclass(w.category, RuntimeWarning)][0].startswith(
                "g++ not found")
    plain = Tokenizer(vocab, scores, 1, 2, native=False)
    assert tok.encode("hello world") == plain.encode("hello world")


def test_scores_that_round_to_one_float32_tie_in_both_loops():
    """The container and the C++ engine hold float32 scores, so the Python
    loop compares them as float32 too: 0.1 and 0.1 + 1e-12 tie, and the
    leftmost pair merges first in both."""
    vocab = (["<pad>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
             + ["a", "b", "ab", "ba", "aba", "bab"])
    scores = [0.0] * 261 + [0.1, 0.1 + 1e-12, 0.5, 0.5]
    tok = Tokenizer(vocab, scores, 1, 2)
    plain = Tokenizer(vocab, scores, 1, 2, native=False)
    assert plain.scores[261] == plain.scores[262]
    for text in ["abab", "baba", "ababab", "bababa", "abba"]:
        assert tok.encode(text) == plain.encode(text), text
