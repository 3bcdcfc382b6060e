#!/usr/bin/env python3
"""Does the flash attention check reject a wrong kernel?  Planted faults,
on the card.

    python3 scripts/torch_flash_faults.py [--int8 | --int4 | --batched]
    # one CUDA device, nvcc

Copies `lmrs_tpu_torch/csrc/flash_attention.cu` into a temporary
directory, plants one fault in each copy, builds every copy with the
package's nvcc flags, and runs the kernel check of `chip_smoke.py` (T 1
and 256 at pos 1,100 and 6,000) plus a short-context case (T 3 at pos 63)
against the plain version with the per-element bound.  Without `--int8`:
kernel C on a bf16 cache at Gemma-2-9B's attention (hd 256, 8 KV heads, 2
query heads each, window 4096, softcap 50), `flash_attention_tol`, the
three tile-walk faults (one K/V tile skipped, the window start one tile
late, the causal diagonal dropped; the two flash-decoding faults below).
With `--int8`: kernel G on an int8
cache at Llama-3.2-3B's attention (hd 128, 8 KV heads, 3 query heads each,
no window: the window fault does not apply), `flash_attention_i8_tol`, the
skipped tile and the dropped diagonal, and two faults of its own (the
value scale left out of the softmax weight; scales read for rows past the
last live one, which hold NaN here as a reused cache may).  With `--int4`:
kernel H on an int4 cache, `flash_attention_i4_tol`, at both packings
(Llama-3.2-3B's attention: pair; Gemma-2-9B's: half), G's faults and two of
its own: the nibbles swapped (low for high), and the `- 8` bias of the low
nibble left out.  With `--batched`: kernels I (per-slot bf16 cache) and J
(bf16 pool, pages of 512 and of 56 rows) at Gemma-2-9B's attention, 8
slots at `chip_smoke.BATCH_POS`, T 1 and 5, `flash_attention_batched_tol`
/ `flash_attention_paged_tol`, and four faults of the batched addressing:
a row read from the slot's previous page (wrong page), the slot stride
one row short, rows past the last live one let through to the trash page
(NaN), and each slot walking its neighbour's position; with the cp
partials (B1: the per-slot cache cut into 4 sequence shards, `return_lse`
on each, merged by kernel M, held with I's bound against the plain version
on the whole cache), two faults of flash-decoding: the shard's row base
`seq_base` left out of the masks, and kernel M dropping each row's last
live split.  Kernel C's set has that merge fault too, and the split
boundaries one tile late (each split's rows shifted by 64: the first
live tile of a call is lost).  Prints the
card's name and power limit, the worst error / bound of every (kernel,
case) and one JSON line.  Exits non-zero if the unchanged kernel fails a
case or a faulty one passes every case.  The repository's sources are
never modified.
"""

from __future__ import annotations

import argparse
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
    # flash-decoding: every split's rows one tile late (the first live
    # tile of each call's range is lost), and kernel M dropping the last
    # live split of a row
    "split_boundary": ("const int s0 = (kv_lo / sp.rows + split) * sp.rows;",
                       "const int s0 = (kv_lo / sp.rows + split) * sp.rows "
                       "+ BKV;"),
    "merge_skip_last": ("for (int s = 0; s < end; ++s) {",
                        "for (int s = 0; s < end - 1; ++s) {"),
}
FAULTS_I8 = {
    "skip_tile": FAULTS["skip_tile"],
    "causal": FAULTS["causal"],
    "value_scale": ("__float2bfloat16_rn(p * vsc[col])",
                    "__float2bfloat16_rn(p)"),
    "stale_scale": ("const bool in = row >= kv_lo && row <= kv_hi;",
                    "const bool in = true;"),
}
FAULTS_I4 = {
    **FAULTS_I8,
    "nibbles_swapped": ("HIGH ? (b >> 4) : ((b & 15) - 8)",
                        "HIGH ? ((b & 15) - 8) : (b >> 4)"),
    "no_bias": ("((b & 15) - 8)", "(b & 15)"),
}
FAULTS_BATCHED = {
    "wrong_page": ("__ldg(w.table + (size_t)slot * w.maxp + vp)",
                   "__ldg(w.table + (size_t)slot * w.maxp + max(vp - 1, 0))"),
    "slot_stride": ("(size_t)slot * w.slot_stride * Stripe<HD, C>::elem;\n"
                    "  vc_raw",
                    "(size_t)slot * (w.slot_stride - row_stride) *\n"
                    "               Stripe<HD, C>::elem;\n  vc_raw"),
    "trash_row": [
        ("        if (row >= kv_lo && row <= kv_hi) {\n"
         "          const int vp",
         "        if (row >= kv_lo && row <= kv_hi + BKV) {\n"
         "          const int vp"),
        ("          kr[b] = vr[b] = make_uint4(0u, 0u, 0u, 0u);\n"
         "          if (row >= kv_lo && row <= kv_hi) {",
         "          kr[b] = vr[b] = make_uint4(0u, 0u, 0u, 0u);\n"
         "          if (row >= kv_lo && row <= kv_hi + BKV) {")],
    "pos_swapped": ("__ldg(w.pos + slot)", "__ldg(w.pos + (slot ^ 1))"),
    "merge_skip_last": FAULTS["merge_skip_last"],
    # the cp partials (B1): the shard's row base left out of the masks
    "seq_base_ignored": (": w.pos0) - w.seq_base;", ": w.pos0);"),
}
S = 8192
# heads, kv heads, head_dim, window, softcap
GEMMA = (16, 8, 256, 4096, 50.0)
LLAMA = (24, 8, 128, None, None)
CASES = [(1, 1100), (1, 6000), (256, 1100), (256, 6000), (3, 63)]


def build_faulty(cuda, work: Path, faults: dict) -> dict:
    src = (cuda.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name, edits in faults.items():
        faulty = src
        for old, new in (edits if isinstance(edits, list) else [edits]):
            if src.count(old) != 1:
                raise RuntimeError(f"fault {name}: its target text is not "
                                   f"in flash_attention.cu exactly once")
            faulty = faulty.replace(old, new)
        path = work / f"{name}.cu"
        path.write_text(faulty)
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


def make_inputs(torch, geometry, quantize, plain, tol_fn, tag=""):
    """The cases of one attention geometry: (case name, q, cache tensors,
    keyword arguments, plain result, bound).  `quantize` is the row
    quantizer of a quantized cache, or None for the bf16 cache."""
    H, KH, HD, window, softcap = geometry
    gen = torch.Generator(device="cuda").manual_seed(1)
    kf = torch.randn(S, KH, HD, device="cuda", generator=gen)
    vf = torch.randn(S, KH, HD, device="cuda", generator=gen)
    kw = dict(n_kv=KH, scale=HD ** -0.5, softcap=softcap, window=window)
    inputs = []
    for t_q, pos in CASES:
        q = torch.randn(t_q, H, HD, device="cuda", generator=gen)
        if quantize is not None:
            rows, scales = quantize(torch.stack([kf, vf]))
            ks, vs = (scales[i].t().contiguous()[None] for i in (0, 1))
            for a in (ks, vs):      # stale scales past the last live row
                a[:, :, pos + t_q:] = float("nan")
            cache = (rows[0][None].contiguous(), rows[1][None].contiguous(),
                     ks, vs)
        else:
            cache = (kf.reshape(1, S, KH * HD).to(torch.bfloat16),
                     vf.reshape(1, S, KH * HD).to(torch.bfloat16))
        inputs.append((f"{tag}T{t_q}_pos{pos}", q, cache, kw,
                       plain(q, *cache, 0, pos, **kw),
                       tol_fn(q, *cache, 0, pos, **kw), pos))
    return inputs


def batched_inputs(torch):
    """Kernel I's and J's cases at Gemma-2-9B's attention (bf16): per-slot
    cache and pools of 512- and 56-row pages holding the same rows, 8
    slots at chip_smoke.BATCH_POS, T 1 and 5; and B1's: the per-slot cache
    cut into 4 sequence shards, `return_lse` on each, merged by kernel M,
    against the plain version on the whole cache with I's bound.  Returns
    (cases as make_inputs gives them, kernel of each case prefix)."""
    from chip_smoke import (BATCH_POS, GEMMA as G, batched_cache,
                            cut_shards, sharded_lse, to_pool)
    from lmrs_tpu_torch.kernels.flash_merge import flash_merge
    from lmrs_tpu_torch.kernels.flash_attention_batched import (
        flash_attention_batched, flash_attention_batched_plain,
        flash_attention_batched_tol)
    from lmrs_tpu_torch.kernels.flash_attention_paged import (
        flash_attention_paged, flash_attention_paged_plain,
        flash_attention_paged_tol)

    (k, v, _, _), _, _ = batched_cache(torch, G, "bf16", BATCH_POS)
    pos = torch.tensor(BATCH_POS, dtype=torch.int32, device="cuda")
    kw = dict(n_kv=G["KH"], scale=G["HD"] ** -0.5, softcap=G["SOFTCAP"],
              window=G["WINDOW"])
    layouts = [("I", (k, v), flash_attention_batched_plain,
                flash_attention_batched_tol),
               ("B1", (k, v), flash_attention_batched_plain,
                flash_attention_batched_tol)]
    for psz in (512, 56):
        kp, vp, table, _, _ = to_pool(torch, (k, v, None, None), psz,
                                      [p + 5 for p in BATCH_POS])
        layouts.append((f"J{psz}", (kp, vp, table),
                        flash_attention_paged_plain,
                        flash_attention_paged_tol))
    gen = torch.Generator(device="cuda").manual_seed(8)
    inputs = []
    for t_q in (1, 5):
        q = torch.randn(len(BATCH_POS), t_q, G["H"], G["HD"], device="cuda",
                        generator=gen)
        for tag, cache, plain, tol_fn in layouts:
            inputs.append((f"{tag}_T{t_q}", q, cache, kw,
                           plain(q, *cache, 0, pos, **kw),
                           tol_fn(q, *cache, 0, pos, **kw), pos))

    def b1_merged(q, k, v, layer, pos, **kw):
        return flash_merge(*sharded_lse(torch, q, cut_shards(k, v), pos,
                                        kw))

    return inputs, {"I": flash_attention_batched, "B1": b1_merged,
                    "J512": flash_attention_paged,
                    "J56": flash_attention_paged}


def main() -> int:
    ap = argparse.ArgumentParser()
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--int8", action="store_true",
                       help="kernel G on an int8 cache instead of kernel C")
    which.add_argument("--int4", action="store_true",
                       help="kernel H on an int4 cache, both packings")
    which.add_argument("--batched", action="store_true",
                       help="kernels I and J: per-slot and paged caches")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from lmrs_tpu_torch.kernels import cuda
    from lmrs_tpu_torch.kernels.flash_attention import (flash_attention,
                                                        flash_attention_plain,
                                                        flash_attention_tol)
    from lmrs_tpu_torch.kernels.flash_attention_i4 import (
        flash_attention_i4, flash_attention_i4_plain, flash_attention_i4_tol)
    from lmrs_tpu_torch.kernels.flash_attention_i8 import (
        flash_attention_i8, flash_attention_i8_plain, flash_attention_i8_tol)
    from lmrs_tpu_torch.quant import quantize_kv_rows, quantize_kv_rows_q4

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    cuda.plain_numerics()
    if args.batched:
        faults = FAULTS_BATCHED
        inputs, kernels = batched_inputs(torch)
    elif args.int4:
        faults, kernel = FAULTS_I4, flash_attention_i4
        fns = (quantize_kv_rows_q4, flash_attention_i4_plain,
               flash_attention_i4_tol)
        inputs = (make_inputs(torch, LLAMA, *fns, tag="pair_")
                  + make_inputs(torch, GEMMA, *fns, tag="half_"))
    elif args.int8:
        faults, kernel = FAULTS_I8, flash_attention_i8
        inputs = make_inputs(torch, LLAMA, quantize_kv_rows,
                             flash_attention_i8_plain, flash_attention_i8_tol)
    else:
        faults, kernel = FAULTS, flash_attention
        inputs = make_inputs(torch, GEMMA, None, flash_attention_plain,
                             flash_attention_tol)

    libs = {"none": cuda.build_all() / "libflash_attention.so"}
    with tempfile.TemporaryDirectory(dir=str(ROOT / "build")) as tmp:
        libs.update(build_faulty(cuda, Path(tmp), faults))
        results = {}
        for name, lib in libs.items():
            cuda._libs["flash_attention"] = ctypes.CDLL(str(lib))
            row = {}
            for case, q, cache, kw, want, tol, pos in inputs:
                if args.batched:
                    kernel = kernels[case.split("_")[0]]
                got = kernel(q, *cache, 0, pos, **kw)
                # a NaN output compares as not <= 1: rejected
                row[case] = ((got - want).abs() / tol).max().item()
            results[name] = row
        cuda._libs.pop("flash_attention")

    print(card)
    print(f"{'fault':16s}" + "".join(f"{c:>18s}" for c in results["none"]))
    for name, row in results.items():
        print(f"{name:16s}" + "".join(f"{r:18.3f}" for r in row.values()))
    print("(worst |kernel - plain| / bound per case; above 1.000 = rejected)")
    ok = all(r <= 1.0 for r in results["none"].values())
    missed = [n for n in faults if all(r <= 1.0 for r in results[n].values())]
    print(json.dumps(dict(card=card, kernel=(
        "flash_attention_batched, flash_attention_paged" if args.batched
        else kernel.__name__),
                          err_over_tol=results,
                          unchanged_kernel_passes=ok, faults_missed=missed)))
    return 0 if ok and not missed else 1


if __name__ == "__main__":
    sys.exit(main())
