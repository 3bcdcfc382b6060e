"""The port's ranks and collectives (`parallel.comm`, `parallel.
distributed`; CPU, gloo): the four collectives of the forward on a tp x cp
= 2 x 2 grid (every rank the same bits, sums in rank order, a row's sum
independent of the rows beside it), `initialize_multihost` with two
processes that serve one mesh Engine (the counterpart of
tests/test_multihost.py: rank 0's greedy tokens are the one-device
engine's), the mesh's decode and speculative chunks (tp = 2 and cp = 2
against the one-device chunk path; one header broadcast a chunk), and
faults: a follower that raises, and one that dies, end rank 0's call with
an error well inside the process group's timeout, and the broken mesh
refuses every later call; ranks whose chunk tokens differ raise.

Tolerances: the collectives bit for bit; greedy tokens token for token
(tests/torch_mesh_cases.py: no near-tie at 1e-3 of the logit scale in
this run); the chunk paths' greedy tokens up to the first near-tie of the
one-device run at the mesh tolerances of tests/torch_mesh_cases.py (tp
1e-3, cp 5e-3 of the logit scale).
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
from lmrs_tpu_torch.parallel.distributed import (DECODE_CHUNK, FORWARD,
                                                 NEW_CACHE, NO_LOGITS, Mesh,
                                                 Shard, _bits,
                                                 choose_backend, load_shard)
from lmrs_tpu_torch.parallel.tp import make_mesh_engine
from torch_mesh_cases import (CP_TOL, LLAMA_SEED, PROMPT, SELF_TOL,
                              agree_until_tie, greedy, open_model, run_ranks,
                              single_engine, teacher_logits, write_model)

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


def test_mesh_chunks_match_one_device_one_header_a_chunk(model):
    """tp = 2 and cp = 2 engines decode through the mesh's chunks (one
    call a chunk: every rank runs it and samples, rank 0 returns the
    tokens): greedy equal to the one-device chunk path up to a near-tie,
    plain and speculative.  A chunk broadcasts one header (its input token
    rides in it) and a speculative chunk the history besides: the
    broadcasts follow the chunks, not the tokens."""
    f = model["f"]
    # a prompt whose stream has no near-tie at the cp tolerance
    prompt = PROMPT[:32]
    one = single_engine(f, prefill_chunk=8)
    n_new = 17
    want = greedy(one, prompt, n_new)
    want_logits = teacher_logits(one, prompt, want)
    prefill = 2 * len(prompt) // 8       # a header and the token ids
    for tp, cp, tol in ((2, 1, SELF_TOL), (1, 2, CP_TOL)):
        eng = make_mesh_engine(f, tp=tp, cp=cp, device="cpu",
                               prefill_chunk=8)
        try:
            mesh = eng.mesh
            for n in (1, 8):
                eng.decode_chunk = n
                mesh.reset_stats()
                got = greedy(eng, prompt, n_new)
                chunks = -(-(n_new - 1) // n)
                # the stats call's own header is the last
                assert mesh.stats()["broadcasts"] == \
                    [prefill + chunks + 1] * (tp * cp), (tp, cp, n)
                agree_until_tie(got, want, want_logits, tol)
            eng.decode_chunk = 4
            mesh.reset_stats()
            got = greedy(eng, prompt, n_new, speculative_k=3)
            chunks = eng.metrics.spec_proposed // (4 * 3)
            assert 1 <= chunks < n_new - 1
            assert mesh.stats()["broadcasts"] == \
                [prefill + 2 * chunks + 1] * (tp * cp)
            agree_until_tie(got, want, want_logits, tol)
        finally:
            eng.close()
            eng.mesh.shutdown()


def test_ranks_whose_chunk_tokens_differ_raise(model):
    """The chunk's agreement check: ranks that sample alike agree and
    return the same tokens; a planted fault (rank 1 seeds its sampler
    otherwise) makes every rank raise after the chunk instead of going on
    with another stream."""
    f = model["f"]

    def chunk(comm, seed_of):
        params, cfg_l = load_shard(f, f.cfg, comm, torch.device("cpu"))
        shard = Shard(comm, f.cfg, cfg_l, params)
        shard.run(NEW_CACHE, [1, 0, 0, 64, 0], [])
        return shard.run(DECODE_CHUNK, [1, 3, 6, _bits(1.0), _bits(1.0),
                                        seed_of(comm.rank), 1], [],
                         torch.tensor([5])).tolist()

    same = run_ranks(2, 2, 1, lambda comm: chunk(comm, lambda r: 7))
    assert same[0] == same[1] and len(same[0]) == 6
    with pytest.raises(RuntimeError, match="chunk tokens differ"):
        run_ranks(2, 2, 1, lambda comm: chunk(comm, lambda r: 7 + r))
