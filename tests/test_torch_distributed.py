"""The port's ranks and collectives (`parallel.comm`, `parallel.
distributed`; CPU, gloo): the four collectives of the forward on a tp x cp
= 2 x 2 grid (every rank the same bits, sums in rank order, a row's sum
independent of the rows beside it), `initialize_multihost` with two
processes that serve one mesh Engine (the counterpart of
tests/test_multihost.py: rank 0's greedy tokens are the one-device
engine's), and faults: a follower that raises, and one that dies, end rank
0's call with an error well inside the process group's timeout, and
the broken mesh refuses every later call.

Tolerances: the collectives bit for bit; greedy tokens token for token
(tests/torch_mesh_cases.py: no near-tie at 1e-3 of the logit scale in
this run).
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from lmrs_tpu_torch.config import ModelType, QuantType
from lmrs_tpu_torch.parallel.distributed import (FORWARD, NO_LOGITS, Mesh,
                                                 choose_backend)
from lmrs_tpu_torch.parallel.tp import make_mesh_engine
from torch_mesh_cases import (LLAMA_SEED, PROMPT, greedy, open_model,
                              run_ranks, single_engine, write_model)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_collectives_on_a_2x2_grid():
    def rank(comm):
        r = comm.rank
        gen = torch.Generator().manual_seed(r)
        x = torch.randn(5, 7, generator=gen)
        out = dict(
            tp=comm.sum(x, "tp"), cp=comm.sum(x, "cp"),
            world=comm.sum(x, "world"), row0=comm.sum(x[:1], "world"),
            max=comm.max(x, "world"),
            last=comm.gather_last(x[:, :3] + 10 * comm.tp_rank, "tp"),
            rows=comm.gather_rows(x[:2] + 10 * comm.cp_rank, "cp"),
            bcast=comm.broadcast(x.clone(), src=2))
        return {k: v.numpy() for k, v in out.items()}, x.numpy()

    res = run_ranks(4, 2, 2, rank)
    xs = [x for _, x in res]
    outs = [o for o, _ in res]
    for key in outs[0]:
        if key not in ("tp", "cp", "last", "rows"):
            for o in outs[1:]:                 # the same bits everywhere
                np.testing.assert_array_equal(o[key], outs[0][key])
    ordered = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    np.testing.assert_array_equal(outs[0]["world"], ordered)
    # row independence: row 0 summed alone is row 0 of the (5, 7) sum
    np.testing.assert_array_equal(outs[0]["row0"][0], ordered[0])
    np.testing.assert_array_equal(outs[0]["max"], np.maximum.reduce(xs))
    np.testing.assert_array_equal(outs[3]["bcast"], xs[2])
    # rank r = tp_rank * 2 + cp_rank: tp groups {0, 2}, {1, 3}
    np.testing.assert_array_equal(outs[2]["tp"], xs[0] + xs[2])
    np.testing.assert_array_equal(outs[1]["cp"], xs[0] + xs[1])
    np.testing.assert_array_equal(
        outs[0]["last"], np.concatenate([xs[0][:, :3], xs[2][:, :3] + 10],
                                        axis=1))
    np.testing.assert_array_equal(
        outs[3]["rows"], np.concatenate([xs[2][:2], xs[3][:2] + 10]))
    assert choose_backend(torch.device("cpu"), 2) == "gloo"


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    path = write_model(d, ModelType.LLAMA, QuantType.Q8_0, **LLAMA_SEED)
    f = open_model(path)
    return dict(path=path, f=f,
                want=greedy(single_engine(f, prefill_chunk=16), PROMPT, 6))


WORKER = """
import sys
import torch
torch.set_num_threads(1)
from lmrs_tpu_torch.parallel.distributed import initialize_multihost
from lmrs_tpu_torch.parallel.tp import make_mesh_engine
from lmrs_tpu_torch.runtime.engine import GenerationConfig
coord, pid, path, prompt = sys.argv[1], int(sys.argv[2]), sys.argv[3], \\
    [int(t) for t in sys.argv[4].split(",")]
assert initialize_multihost(coord, 2, pid, backend="gloo", timeout=60)
# rank 1 serves as a follower inside and leaves when rank 0 stops
eng = make_mesh_engine(path, tp=2, device="cpu", prefill_chunk=16)
toks = eng.generate(prompt, GenerationConfig(temperature=0.0,
                                             max_new_tokens=6))
print("WORKER_RESULT", ",".join(map(str, toks)), flush=True)
eng.mesh.shutdown()
"""


def test_initialize_multihost_two_processes(model):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, coord, str(pid), model["path"],
         ",".join(map(str, PROMPT))], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid}:\n{out[-3000:]}"
    got = [ln.split()[1] for ln in outs[0].splitlines()
           if ln.startswith("WORKER_RESULT")]
    assert got == [",".join(map(str, model["want"]))]
    assert "WORKER_RESULT" not in outs[1]      # the follower samples nothing


def test_a_follower_that_raises_fails_the_call(model):
    """A fault planted in the follower alone (a cache id only rank 0
    holds: its forward raises KeyError there) makes rank 0's call
    raise as soon as the follower exits, not after the 60 s timeout."""
    mesh = Mesh.start(model["f"], tp=2, device="cpu", timeout=60)
    try:
        from lmrs_tpu_torch.models.transformer import new_cache

        mesh.shard.caches[99] = new_cache(mesh.cfg_l, mesh.device, 0,
                                          torch.bfloat16, 64, 0)
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError):
            mesh.call(FORWARD, [99, -1, 0, NO_LOGITS, 1],
                      [torch.tensor(PROMPT[:4])])
        assert time.perf_counter() - t0 < 30
        mesh.procs[0].join(10)
        assert mesh.procs[0].exitcode == 1
        with pytest.raises(RuntimeError, match="failed earlier"):
            mesh.stats()
    finally:
        mesh.shutdown()


def test_a_follower_that_dies_fails_the_engine(model):
    eng = make_mesh_engine(model["f"], tp=2, device="cpu", prefill_chunk=16)
    try:
        assert greedy(eng, PROMPT, 6) == model["want"]
        eng.mesh.procs[0].kill()
        eng.mesh.procs[0].join(10)
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="mesh rank 1 exited"):
            greedy(eng, PROMPT, 6)
        assert time.perf_counter() - t0 < 30
    finally:
        eng.mesh.shutdown()
