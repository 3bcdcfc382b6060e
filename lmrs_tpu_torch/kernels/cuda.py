"""Build the CUDA kernels of `lmrs_tpu_torch/csrc`, load them with ctypes,
and pin the numerics of the plain versions that run beside them.

Each `csrc/<name>.cu` compiles with `nvcc -gencode arch=compute_90a,
code=sm_90a` into its own shared library with a plain C interface (no
PyTorch headers, so a build takes seconds).  All sources build in parallel,
one nvcc process each, at first use, into `build/lmrs_tpu_torch/<hash>/`
at the repository root; the hash covers the sources and the flags, so an
unchanged tree never rebuilds.  Nothing here runs at import time: the CPU
tests import every module of the package on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "lmrs_tpu_torch"
SOURCES = ("q4_gemv", "q4_gemm", "flash_attention", "q8_gemv_i8", "q8_gemv",
           "q8_gemm", "ffn_fused")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "lmrs_tpu_torch build only where the CUDA "
                           "toolkit is installed")
    return found


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source that has no library yet, all in parallel.
    Raises with nvcc's output if any compile fails.  Each compile's ptxas
    report (registers, shared memory, spills) is kept beside its library
    as <name>.log."""
    out = build_dir()
    todo = [n for n in SOURCES if not (out / f"lib{n}.so").exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = out / f"lib{n}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), tmp)
    failed = []
    for n, (p, tmp) in procs.items():
        log, _ = p.communicate()
        (out / f"{n}.log").write_bytes(log)
        if p.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {p.returncode}) ---\n"
                          + log.decode(errors="replace"))
        else:
            os.replace(tmp, out / f"lib{n}.so")   # atomic: readers never
            # see a half-written library
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of csrc/<name>.cu, built on first use."""
    with _lock:
        if name not in _libs:
            if name not in SOURCES:
                raise KeyError(name)
            _libs[name] = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
        return _libs[name]


def plain_numerics() -> None:
    """Full float32 products for a plain version running on the card:
    TF32 would keep ~3 decimal digits where the kernels accumulate in f32.
    PyTorch's default already keeps TF32 off for matmuls (not for cuDNN);
    both are set so that no setting elsewhere in the process changes the
    plain versions' numbers."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h."""
    _fields_ = [("func", ctypes.c_void_p),
                *((f, ctypes.c_uint) for f in (
                    "grid_x", "grid_y", "grid_z", "block_x", "block_y",
                    "block_z", "shared_bytes")),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


def demangle(name: bytes) -> str:
    """A C++ symbol as the C++ runtime's demangler (and so the profiler's
    device trace) writes it; the symbol itself if it is not mangled."""
    fn = ctypes.CDLL("libstdc++.so.6").__cxa_demangle
    fn.restype = ctypes.c_void_p
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int)]
    status = ctypes.c_int()
    p = fn(name, None, None, ctypes.byref(status))
    if status.value != 0 or not p:
        return name.decode()
    try:
        return ctypes.string_at(p).decode()
    finally:
        ctypes.CDLL(None).free(ctypes.c_void_p(p))


def graph_kernels(graph) -> Dict[str, int]:
    """The kernel nodes of a captured `torch.cuda.CUDAGraph(keep_graph=
    True)`, counted by their function's demangled name: what every replay
    launches, read from the graph itself through libcuda."""
    cu = ctypes.CDLL("libcuda.so.1")
    ptr, size_p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
    name_p = ctypes.POINTER(ctypes.c_char_p)
    for fn, args in ((cu.cuGraphGetNodes, [ptr, ptr, size_p]),
                     (cu.cuGraphNodeGetType,
                      [ptr, ctypes.POINTER(ctypes.c_int)]),
                     (cu.cuGraphKernelNodeGetParams_v2,
                      [ptr, ctypes.POINTER(_KernelNodeParams)]),
                     (cu.cuFuncGetName, [name_p, ptr]),
                     (cu.cuKernelGetName, [name_p, ptr])):
        fn.argtypes, fn.restype = args, ctypes.c_int

    def call(fn, *args):
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{fn.__name__}: CUDA error {err}")

    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    call(cu.cuGraphGetNodes, raw, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call(cu.cuGraphGetNodes, raw, nodes, ctypes.byref(n))
    out: Dict[str, int] = {}
    for node in nodes[:n.value]:
        kind, node = ctypes.c_int(), ctypes.c_void_p(node)
        call(cu.cuGraphNodeGetType, node, ctypes.byref(kind))
        if kind.value != 0:                  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params, name = _KernelNodeParams(), ctypes.c_char_p()
        call(cu.cuGraphKernelNodeGetParams_v2, node, ctypes.byref(params))
        if params.func:
            call(cu.cuFuncGetName, ctypes.byref(name), params.func)
        else:
            call(cu.cuKernelGetName, ctypes.byref(name), params.kern)
        key = demangle(name.value)
        out[key] = out.get(key, 0) + 1
    return out
