"""Shared pieces of the port's mesh tests (tests/test_torch_tp.py,
test_torch_cp.py, test_torch_mesh_scheduler.py, test_torch_replicas.py,
test_torch_distributed.py): tiny models written from a seed, meshes of
gloo ranks on the CPU (`parallel.distributed.Mesh`), and the greedy and
logit comparisons.  Imports no JAX.

Tolerances used by the tests:
- a mesh against the port's one-device path on the same file: max |logit
  difference| <= 1e-3 * max |logit| + 1e-5, the repo's near-tie bound
  (the same quantized groups on every rank; only f32 summation order
  differs: partial products summed over tp, softmax pieces merged over
  cp; Gemma's post-attention and post-FFN norms rescale the small sums,
  which measured 3e-4 of the scale at tp = 2), and greedy tokens equal up
  to the first step whose top-2 margin is below that;
- a cp mesh against the port's one-device path: 5e-3 of the logit scale
  + 1e-5: each shard rounds its softmax weights exp(s - m) to bf16 against
  its own max m, one device against the global max (the merge's two
  levels round differently by design, as kernel B1's card check states);
  measured 2.4e-3 at cp = 2; 1e-2 (ROUNDING_TOL) over a prompt
  prefilled a row at a time, whose every row takes the W8A8 matmuls (a
  difference that flips one activation quantizer's rounding step moves a
  row by up to 1/127 of its largest value: 6e-3 measured), and over the
  int8 and int4 caches (the cp partials fold the scales into the scores
  and weights, kernels G's and H's plain versions into the rows: 5.5e-3
  measured for int4);
- against the JAX single-device engine: 1e-2 * max |logit| + 1e-4, the
  bound of tests/test_torch_transformer.py (the JAX stacked kernels round
  activations to bf16 where the port keeps f32), greedy tokens up to the
  first near-tie at that bound.
"""

from __future__ import annotations

import numpy as np
import torch

from lmrs_tpu_torch.config import ModelType, QuantType
from lmrs_tpu_torch.io.lmrs import read_lmrs, write_lmrs
from lmrs_tpu_torch.io.params import params_from_lmrs
from lmrs_tpu_torch.io.synthetic import random_weights
from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig

SELF_TOL = (1e-3, 1e-5)
CP_TOL = (5e-3, 1e-5)
ROUNDING_TOL = (1e-2, 1e-5)
JAX_TOL = (1e-2, 1e-4)
# a prompt of random ids (seed 0)
PROMPT = [int(t) for t in np.random.default_rng(0).integers(3, 2000, 40)]
# seeds and weight scales whose greedy streams of PROMPT are not one
# repeated token
LLAMA_SEED = dict(seed=4, scale=0.1)
GEMMA_SEED = dict(seed=5, scale=0.02)


def tiny(family: ModelType, quant: QuantType, **kw):
    """The tiny presets' geometry (dim 256, 4 layers, 8 heads of 32 on 4
    kv heads, vocabulary 2,048, context 512, groups of 32)."""
    from lmrs_tpu_torch.config import tiny_gemma, tiny_llama

    make = tiny_gemma if family == ModelType.GEMMA else tiny_llama
    return make(quant=quant, **kw)


def write_model(directory, family: ModelType, quant: QuantType,
                seed: int = 1, scale: float = 0.05, **kw) -> str:
    """A random .lmrs file (weights of std `scale`, numpy seed `seed`)."""
    cfg = tiny(family, quant, **kw)
    path = str(directory / f"{family.name}_{quant.name}_{seed}.lmrs")
    write_lmrs(path, cfg, random_weights(cfg, seed, scale))
    return path


def open_model(path: str, **overrides):
    """The parsed file with config overrides (the header carries no
    window: Gemma's sliding_window is set here when a test shrinks it)."""
    f = read_lmrs(path)
    if overrides:
        f.cfg = f.cfg.replace(**overrides)
    return f


def single_engine(f, **kw) -> Engine:
    """The port's one-device Engine on the CPU over the same file."""
    return Engine(f.cfg, params_from_lmrs(f, device="cpu"), device="cpu",
                  **kw)


def greedy(engine: Engine, prompt, n: int, **gen) -> list:
    engine.reset()
    return engine.generate(prompt, GenerationConfig(
        temperature=0.0, max_new_tokens=n, **gen))


def teacher_logits(engine: Engine, prompt, stream) -> np.ndarray:
    """(len(stream), V) logits: the prompt's last row, then one decode
    step on each of stream[:-1] (teacher-forced)."""
    engine.reset()
    with torch.no_grad():
        rows = [engine.prefill(prompt)]
        for t in stream[:-1]:
            rows.append(engine.decode_step(t))
    return torch.stack(rows).float().cpu().numpy()


def bound(logits: np.ndarray, tol) -> float:
    rel, ab = tol
    return rel * float(np.abs(logits).max()) + ab


def agree_until_tie(got, want, want_logits: np.ndarray, tol,
                    min_steps: int = 4) -> int:
    """Assert that greedy tokens agree up to the first step whose top-2
    margin in `want_logits` is below the tolerance's bound (that step may
    go either way), and that at least `min_steps` are compared; returns
    how many were."""
    top2 = np.sort(want_logits, axis=-1)[:, -2:]
    close = np.nonzero(top2[:, 1] - top2[:, 0] < bound(want_logits,
                                                       tol))[0]
    n = int(close[0]) if close.size else len(want)
    assert n >= min(min_steps, len(want)), (n, close)
    assert got[:n] == want[:n], (got, want, n)
    return n


def assert_close(got: np.ndarray, want: np.ndarray, tol) -> float:
    err = float(np.abs(got - want).max())
    assert err <= bound(want, tol), (err, bound(want, tol))
    return err


def run_ranks(n: int, tp: int, cp: int, fn, timeout: float = 60.0):
    """Run fn(comm) on n = tp * cp gloo ranks that are threads of this
    process (`parallel.distributed.connect` over one TCP store on
    localhost); returns the ranks' results in rank order and raises the
    first rank's error."""
    import datetime
    import threading

    import torch.distributed as dist

    from lmrs_tpu_torch.parallel.distributed import connect

    store = dist.TCPStore("127.0.0.1", 0, n, True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout))
    out, errors = [None] * n, []

    def rank(r):
        try:
            s = store if r == 0 else dist.TCPStore(
                "127.0.0.1", store.port, n, False,
                timeout=datetime.timedelta(seconds=timeout))
            out[r] = fn(connect(s, r, tp, cp, torch.device("cpu"), "gloo",
                                timeout))
        except BaseException as e:  # raised on the calling thread
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if errors:
        raise errors[0]
    return out
