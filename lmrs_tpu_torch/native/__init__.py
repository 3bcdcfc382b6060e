"""ctypes binding of the native (C++) tokenizer merge loop and Q4 repack.

`tokenizer.cpp` compiles with `g++ -O2 -shared -fPIC` (no make) at first
use into `build/lmrs_tpu_torch/native/<hash>/` at the repository root; the
hash covers the source and the flags, so an unchanged tree never rebuilds.
The compile writes a temporary name that `os.replace` then moves into
place, under a file lock, so that processes building at once (test
workers) wait for one compile and never load a half-written library.  A
failed compile raises with g++'s output; a missing g++ raises
`CompilerMissing`, which `Tokenizer` takes as its cue to keep its
pure-Python merge loop.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "tokenizer.cpp"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
              / "lmrs_tpu_torch" / "native")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
LIB_NAME = "liblmrs_native.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class CompilerMissing(RuntimeError):
    """No g++ on this machine: the native library cannot be built."""


def build(root: Path = BUILD_ROOT) -> Path:
    """The path of the built library under `root`, compiling it first if
    no process has yet.  Raises `CompilerMissing` without g++, and
    RuntimeError with g++'s output if the compile fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise CompilerMissing("g++ not found: the native tokenizer engine "
                              "of lmrs_tpu_torch cannot be built")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out = Path(root) / h.hexdigest()[:16]
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if lib.exists():                   # another process built it
            return lib
        tmp = out / f"{LIB_NAME}.{os.getpid()}.tmp"
        r = subprocess.run([gxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {SOURCE.name} (exit "
                               f"{r.returncode}):\n{r.stdout}{r.stderr}")
        os.replace(tmp, lib)
    return lib


def bind(path: Path) -> ctypes.CDLL:
    """Load the library at `path` and declare its C entry points."""
    lib = ctypes.CDLL(str(path))
    lib.lmrs_tok_from_buffer.restype = ctypes.c_void_p
    lib.lmrs_tok_from_buffer.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.lmrs_tok_free.restype = None
    lib.lmrs_tok_free.argtypes = [ctypes.c_void_p]
    lib.lmrs_tok_merge.restype = ctypes.c_int64
    lib.lmrs_tok_merge.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_uint32),
                                   ctypes.c_int64]
    lib.lmrs_q4_repack.restype = None
    lib.lmrs_q4_repack.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_uint64, ctypes.c_uint32]
    return lib


def library() -> ctypes.CDLL:
    """This process's loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(build())
        return _lib


def q4_repack(src: np.ndarray, group_size: int) -> np.ndarray:
    """File-layout Q4 bytes (adjacent-pair nibbles) -> the runtime layout
    (group halves, XOR 0x80), as `quant.q4_file_to_runtime_np`; a new
    uint8 array of src's shape."""
    src = np.ascontiguousarray(src).view(np.uint8)
    if group_size % 4 or src.size % (group_size // 2):
        raise ValueError(f"{src.size} bytes do not split into Q4 groups of "
                         f"{group_size}")
    dst = np.empty_like(src)
    library().lmrs_q4_repack(src.ctypes.data_as(ctypes.c_void_p),
                             dst.ctypes.data_as(ctypes.c_void_p),
                             src.size, group_size)
    return dst


class NativeTokenizerEngine:
    """The merge loop over a `tokenizer.bin` image parsed by the C++
    engine."""

    def __init__(self, container_bytes: bytes):
        self._lib = library()
        # the engine copies what it needs: the bytes may go after this
        self._handle = self._lib.lmrs_tok_from_buffer(container_bytes,
                                                      len(container_bytes))
        if not self._handle:
            raise ValueError("the native tokenizer engine could not parse "
                             "the container")

    def merge(self, tokens: List[int]) -> List[int]:
        """The greedy scored merge of `tokens` (ids past the vocabulary
        pass through unmerged)."""
        n = len(tokens)
        if n and not 0 <= min(tokens) <= max(tokens) < 1 << 32:
            raise ValueError("token ids must fit an unsigned 32-bit int")
        arr = (ctypes.c_uint32 * n)(*tokens)
        return list(arr[:self._lib.lmrs_tok_merge(self._handle, arr, n)])

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.lmrs_tok_free(handle)
            self._handle = None
