"""Data-parallel serving of the port (`serve.replicas.ReplicaRouter`,
`make_replica_router`; CPU) against the JAX ReplicaRouter and the
one-device scheduler: placement on the least-loaded replica (the JAX
router's choices for the same submissions), conversation leases pinned to
the replica that holds their KV, `run_threaded` (one stepping thread a
replica), `start_threads` (the backend's live stepping), and dp x tp =
2 x 2 (two meshes of two gloo ranks, this process rank 0 of both, stepped
from two threads at once).

Tolerance: token for token against the one-device scheduler (a replica is
that scheduler; over tp = 2 see tests/test_torch_mesh_scheduler.py).
"""

import threading

import pytest
import torch

from lmrs_tpu_torch.config import ModelType, QuantType
from lmrs_tpu_torch.serve.replicas import RouterLease, make_replica_router
from test_torch_scheduler import PROMPTS, build, run, sched

torch.set_num_threads(1)

N_NEW = 8
KW = dict(max_batch=2, max_ctx=64, cache_dtype=torch.float32,
          prefill_chunk=8, decode_chunk=4, temperature=0.0)
WAVE = PROMPTS + [[9, 8, 7], [4, 4, 2, 1]]


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = tmp_path_factory.mktemp("replicas")
    cfg, params = build(d, ModelType.LLAMA, QuantType.Q8_0, seed=2)
    path = str(d / "m2_LLAMA.lmrs")
    want = run(sched(cfg, params, **KW), WAVE, N_NEW)
    return dict(cfg=cfg, params=params, path=path, want=want)


def test_router_places_as_the_jax_router(model):
    """Five submissions without leases go to the least-loaded replica in
    turn, the JAX ReplicaRouter's choices on two devices; the streams are
    the one-device scheduler's, stepped in turn and on a thread each."""
    import jax

    import lmrs_tpu.io.lmrs as jl
    from lmrs_tpu.serve.replicas import ReplicaRouter as JaxRouter

    jr = JaxRouter(jl.read_lmrs(model["path"]), dp=2,
                   devices=jax.devices()[:2], max_batch=2, max_ctx=64,
                   prefill_chunk=8, decode_chunk=4, temperature=0.0)
    router = make_replica_router(model["path"], dp=2,
                                 devices=["cpu", "cpu"], **KW)

    def sides(r):
        out = []
        for p in WAVE:
            before = [len(x.waiting) for x in r.replicas]
            r.submit(p, max_new_tokens=N_NEW)
            after = [len(x.waiting) for x in r.replicas]
            out.append([a - b for a, b in zip(after, before)].index(1))
        return out

    assert sides(router) == sides(jr) == [0, 1, 0, 1, 0]
    router.run()
    assert router.tokens_emitted == N_NEW * len(WAVE)
    # the same wave on a stepping thread a replica
    done = {}
    for i, p in enumerate(WAVE):
        router.submit(p, max_new_tokens=N_NEW,
                      on_done=lambda o, i=i: done.setdefault(i, o))
    router.run_threaded()
    assert [done[i] for i in range(len(WAVE))] == model["want"]


def test_leases_stay_on_their_replica(model):
    """Conversations lease slots on the least-loaded replica that has
    one free, a lease counting as load; a turn on a lease runs on that
    replica, continues its KV, and gives the one-device scheduler's
    two-turn stream; the router is full when every replica's slots are
    leased."""
    router = make_replica_router(model["path"], dp=2,
                                 devices=["cpu", "cpu"], **KW)
    leases = [router.new_conversation() for _ in range(4)]
    # a lease is load from the start (unlike the JAX router's `_load`,
    # which counts requests in flight only): conversations alternate
    assert [lz.replica for lz in leases] == [0, 1, 0, 1]
    assert router.new_conversation() is None
    got = {}
    for turn in range(2):
        router.submit(PROMPTS[turn], lease=leases[1], max_new_tokens=N_NEW,
                      on_done=lambda o, t=turn: got.setdefault(t, o))
        assert len(router.replicas[1].waiting) == 1
        assert not router.replicas[0].waiting
        router.run()
    one = sched(model["cfg"], model["params"], **KW)
    lease = one.new_conversation()
    want = {}
    for turn in range(2):
        one.submit(PROMPTS[turn], lease=lease, max_new_tokens=N_NEW,
                   on_done=lambda o, t=turn: want.setdefault(t, o))
        one.run()
    assert got == want
    for lz in leases:
        router.end_conversation(lz)
    assert isinstance(router.new_conversation(), RouterLease)


def test_router_threads_serve_leases(model):
    """After `start_threads` (the backend's --dp) each replica steps on a
    thread of its own, and leases, turns and their ends reach it there:
    the placement of test_leases_stay_on_their_replica, the one-device
    scheduler's streams, and the threads gone after close()."""
    router = make_replica_router(model["path"], dp=2,
                                 devices=["cpu", "cpu"], **KW)
    threads = router.start_threads()
    try:
        leases = [router.new_conversation() for _ in range(4)]
        assert [lz.replica for lz in leases] == [0, 1, 0, 1]
        done, events = {}, [threading.Event() for _ in leases]
        for i, (lz, ev) in enumerate(zip(leases, events)):
            router.submit(WAVE[i], lease=lz, max_new_tokens=N_NEW,
                          on_done=lambda o, i=i, ev=ev: (
                              done.setdefault(i, o), ev.set()))
        assert all(ev.wait(120) for ev in events)
        assert [done[i] for i in range(4)] == model["want"][:4]
        for lz in leases:
            router.end_conversation(lz)
        assert router.new_conversation().replica == 0
    finally:
        router.close()
    assert not any(t._thread.is_alive() for t in threads)


def test_dp_over_tp_meshes(model):
    """dp x tp = 2 x 2: each replica a mesh scheduler of two ranks, both
    stepped at once from threads of this process (two process groups):
    the one-device scheduler's streams."""
    router = make_replica_router(model["path"], dp=2, tp=2,
                                 devices=["cpu"] * 4, **KW)
    try:
        assert all(r.mesh.tp == 2 for r in router.replicas)
        done = {}
        for i, p in enumerate(WAVE):
            router.submit(p, max_new_tokens=N_NEW,
                          on_done=lambda o, i=i: done.setdefault(i, o))
        router.run_threaded()
        assert [done[i] for i in range(len(WAVE))] == model["want"]
    finally:
        router.close()
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_replica_router(model["path"], dp=2, tp=2, devices=["cpu"] * 3,
                            **KW)
