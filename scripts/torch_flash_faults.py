#!/usr/bin/env python3
"""Does the flash attention check reject a wrong kernel?  Planted faults,
on the card.

    python3 scripts/torch_flash_faults.py        # one CUDA device, nvcc

Copies `lmrs_tpu_torch/csrc/flash_attention.cu` into a temporary
directory, plants one tile-walk fault in each copy (one K/V tile skipped,
the window start one tile late, the causal diagonal dropped), builds every
copy with the package's nvcc flags, and runs the kernel check of
`chip_smoke.py` (Gemma-2-9B attention: hd 256, 8 KV heads, 2 query heads
each, window 4096, softcap 50; T 1 and 256 at pos 1,100 and 6,000) plus a
short-context case (T 3 at pos 63) against the plain version with the
per-element bound `flash_attention_tol`.  Prints the card's name and power
limit, the worst error / bound of every (kernel, case) and one JSON line.
Exits non-zero if the unchanged kernel fails a case or a faulty one passes
every case.  The repository's sources are never modified.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name -> (text in flash_attention.cu, its faulty replacement)
FAULTS = {
    "skip_tile": (
        "    __syncthreads();   // previous tile's readers are done",
        "    if (kv0 == (kv_lo / BKV + 2) * BKV) continue;\n"
        "    __syncthreads();   // previous tile's readers are done"),
    "window_start": ("window >= 0 ? max(pos + t_lo - window, 0)",
                     "window >= 0 ? max(pos + t_lo - window + BKV, 0)"),
    "causal": ("key <= q_pos &&", "key < q_pos &&"),
}
H, KH, HD, WINDOW, SOFTCAP, S = 16, 8, 256, 4096, 50.0, 8192
CASES = [(1, 1100), (1, 6000), (256, 1100), (256, 6000), (3, 63)]


def build_faulty(cuda, work: Path) -> dict:
    src = (cuda.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name, (old, new) in FAULTS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"fault {name}: its target text is not in "
                               f"flash_attention.cu exactly once")
        path = work / f"{name}.cu"
        path.write_text(src.replace(old, new))
        lib = work / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib)
    libs = {}
    for name, (p, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {name}: {log.decode(errors='replace')}")
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from lmrs_tpu_torch.kernels import cuda
    from lmrs_tpu_torch.kernels.flash_attention import (flash_attention,
                                                        flash_attention_plain,
                                                        flash_attention_tol)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    cuda.plain_numerics()
    gen = torch.Generator(device="cuda").manual_seed(1)
    k = torch.randn(1, S, KH * HD, device="cuda", generator=gen).to(
        torch.bfloat16)
    v = torch.randn(1, S, KH * HD, device="cuda", generator=gen).to(
        torch.bfloat16)
    kw = dict(n_kv=KH, scale=HD ** -0.5, softcap=SOFTCAP, window=WINDOW)
    inputs = []
    for t_q, pos in CASES:
        q = torch.randn(t_q, H, HD, device="cuda", generator=gen)
        inputs.append((t_q, pos, q, flash_attention_plain(q, k, v, 0, pos,
                                                          **kw),
                       flash_attention_tol(q, k, v, 0, pos, **kw)))

    libs = {"none": cuda.build_all() / "libflash_attention.so"}
    with tempfile.TemporaryDirectory(dir=str(ROOT / "build")) as tmp:
        libs.update(build_faulty(cuda, Path(tmp)))
        results = {}
        for name, lib in libs.items():
            cuda._libs["flash_attention"] = ctypes.CDLL(str(lib))
            row = {}
            for t_q, pos, q, want, tol in inputs:
                got = flash_attention(q, k, v, 0, pos, **kw)
                row[f"T{t_q}_pos{pos}"] = ((got - want).abs() / tol).max(
                ).item()
            results[name] = row
        cuda._libs.pop("flash_attention")

    print(card)
    print(f"{'fault':14s}" + "".join(f"{c:>14s}" for c in results["none"]))
    for name, row in results.items():
        print(f"{name:14s}" + "".join(f"{r:14.3f}" for r in row.values()))
    print("(worst |kernel - plain| / bound per case; above 1.000 = rejected)")
    ok = all(r <= 1.0 for r in results["none"].values())
    missed = [n for n in FAULTS if all(r <= 1.0 for r in results[n].values())]
    print(json.dumps(dict(card=card, err_over_tol=results,
                          unchanged_kernel_passes=ok, faults_missed=missed)))
    return 0 if ok and not missed else 1


if __name__ == "__main__":
    sys.exit(main())
