"""The port's continuous-batching scheduler (`serve.scheduler.BatchScheduler`
on the CPU, the kernels' plain versions) over its contiguous per-slot
cache: batched greedy decoding must give the single-stream `Engine`'s
tokens under staggered admission, leases, stop tokens, slot reuse, the
admission prefix cache and speculation, as tests/test_scheduler.py holds
the JAX scheduler.  The paged pool: tests/test_torch_paged.py.  One test
holds the port's scheduler against the JAX scheduler on the same model.

Tolerances, stated at each assert:
- port scheduler vs port Engine, greedy: token for token (both run the
  same plain versions; the tiny models' logits have no near-ties on these
  prompts, and the T of a matmul does not change a row's result here).
- port vs JAX scheduler: token for token up to the first step whose top-2
  logit margin in a plain single-stream run is below 1e-2 of the logit
  scale (the two packages' logits differ by up to that much,
  tests/test_torch_transformer.py).
"""

import numpy as np
import pytest
import torch

from lmrs_tpu_torch.config import ModelType, QuantType
from lmrs_tpu_torch.io.lmrs import read_lmrs, write_lmrs
from lmrs_tpu_torch.io.params import params_from_lmrs
from lmrs_tpu_torch.io.synthetic import random_weights, tiny_config
from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig
from lmrs_tpu_torch.serve.scheduler import (BatchScheduler, auto_pool_tokens,
                                            paged_supported)

torch.set_num_threads(1)

PROMPTS = [[1, 5, 9], [2, 4], [7, 3, 11, 13]]
N_NEW = 10


def build(tmp_path, model_type=ModelType.LLAMA, quant=QuantType.Q8_0,
          seed=1, **kw):
    """(config, CPU params) of a random tiny .lmrs (the JAX scheduler
    tests' geometry unless `kw` says otherwise)."""
    base = dict(dim=64, hidden_dim=128, n_layers=2, vocab_size=256,
                group_size=32, seq_len=128)
    base.update(kw)
    cfg = tiny_config(model_type, quant, **base)
    path = str(tmp_path / f"m{seed}_{model_type.name}.lmrs")
    write_lmrs(path, cfg, random_weights(cfg, seed))
    f = read_lmrs(path)
    # the header carries no window: a family constant, set again
    return (f.cfg.replace(sliding_window=cfg.sliding_window),
            params_from_lmrs(f, device="cpu"))


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return build(tmp_path_factory.mktemp("sched"))


def engine_outputs(cfg, params, prompts=PROMPTS, n_new=N_NEW,
                   cache_dtype=torch.float32):
    outs = []
    for p in prompts:
        eng = Engine(cfg, params, device="cpu", cache_dtype=cache_dtype)
        outs.append(eng.generate(
            p, GenerationConfig(temperature=0.0, max_new_tokens=n_new)))
    return outs


def sched(cfg, params, **kw):
    base = dict(max_batch=4, max_ctx=64, cache_dtype=torch.float32,
                prefill_chunk=8, decode_chunk=4, temperature=0.0,
                device="cpu")
    base.update(kw)
    return BatchScheduler(cfg, params, **base)


def run(s, prompts=PROMPTS, n_new=N_NEW, **submit_kw):
    done = {}
    for i, p in enumerate(prompts):
        s.submit(p, max_new_tokens=n_new,
                 on_done=lambda o, i=i: done.setdefault(i, o), **submit_kw)
    s.run()
    return [done.get(i) for i in range(len(prompts))]


@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_batched_matches_single_stream(tmp_path, model, family):
    """Gemma exercises the extra norms, both softcaps, the window and the
    sqrt(dim) embedding scale in the batched forward."""
    if family == "llama":
        cfg, params = model
    else:
        cfg, params = build(tmp_path, ModelType.GEMMA, QuantType.Q4_0,
                            seed=3)
    want = engine_outputs(cfg, params)
    assert run(sched(cfg, params)) == want


def test_staggered_admission(model):
    """A request admitted while another decodes gives its tokens alone
    (slot reuse, stale rows past pos masked)."""
    cfg, params = model
    want = engine_outputs(cfg, params)
    s = sched(cfg, params, max_batch=2)
    done = {}
    s.submit(PROMPTS[0], max_new_tokens=N_NEW,
             on_done=lambda o: done.setdefault(0, o))
    s.step()
    s.step()
    s.submit(PROMPTS[1], max_new_tokens=N_NEW,
             on_done=lambda o: done.setdefault(1, o))
    s.submit(PROMPTS[2], max_new_tokens=N_NEW,       # waits: B = 2
             on_done=lambda o: done.setdefault(2, o))
    s.run()
    assert [done[i] for i in range(3)] == want


def _two_turns(cfg, params):
    eng = Engine(cfg, params, device="cpu", cache_dtype=torch.float32)
    g = GenerationConfig(temperature=0.0, max_new_tokens=4)
    return eng.generate(PROMPTS[0], g), eng.generate(PROMPTS[1], g)


@pytest.mark.parametrize("other_traffic", [False, True])
def test_conversation_lease_multi_turn(model, other_traffic):
    """A leased conversation's second turn equals an Engine running both
    turns; with other traffic decoding in the next slot while the lease
    sits idle (idle lanes write at their own dead rows)."""
    cfg, params = model
    turn1, turn2 = _two_turns(cfg, params)
    s = sched(cfg, params, max_batch=2, max_ctx=128)
    lease = s.new_conversation()
    done = {}
    s.submit(PROMPTS[0], max_new_tokens=4, lease=lease,
             on_done=lambda o: done.setdefault("t1", o))
    s.run()
    if other_traffic:
        s.submit(PROMPTS[2], max_new_tokens=10,
                 on_done=lambda o: done.setdefault("other", o))
        s.run()
        assert len(done["other"]) == 10
    s.submit(PROMPTS[1], max_new_tokens=4, lease=lease,
             on_done=lambda o: done.setdefault("t2", o))
    s.run()
    s.end_conversation(lease)
    assert done["t1"] == turn1 and done["t2"] == turn2
    assert s.slots[lease.slot_idx].lease is None
    assert s.new_conversation() is not None


def test_capacity_of_leases(model):
    cfg, params = model
    s = sched(cfg, params, max_batch=2)
    a, b = s.new_conversation(), s.new_conversation()
    assert a is not None and b is not None
    assert s.new_conversation() is None         # every slot leased
    s.end_conversation(a)
    assert s.new_conversation() is not None


def test_stop_tokens_and_slot_reuse(model):
    cfg, params = model
    want = engine_outputs(cfg, params)
    stop_idx = next(i for i, t in enumerate(want[0])
                    if i > 0 and t not in want[0][:i])
    stop = want[0][stop_idx]
    s = sched(cfg, params, max_batch=2)
    done = {}
    s.submit(PROMPTS[0], max_new_tokens=N_NEW, stop_tokens=[stop],
             on_done=lambda o: done.setdefault(0, o))
    s.run()
    assert done[0] == want[0][:stop_idx + 1]
    s.submit(PROMPTS[1], max_new_tokens=N_NEW,
             on_done=lambda o: done.setdefault(1, o))
    s.run()
    assert done[1] == want[1]
    assert all(sl.req is None and sl.pos == 0 for sl in s.slots)


def test_admission_does_not_stall_active_streams(model):
    """A long prompt is admitted one prefill chunk per tick while the
    active slot keeps emitting a decode chunk every tick."""
    cfg, params = model
    s = sched(cfg, params, max_batch=2, max_ctx=128)
    a_tokens = []
    s.submit([1, 2, 3], max_new_tokens=80, on_token=a_tokens.append)
    for _ in range(3):
        s.step()
    a_before = len(a_tokens)
    assert a_before > 0
    b = s.submit(list(np.random.default_rng(5).integers(1, 250, 64)),
                 max_new_tokens=4)
    ticks = 0
    while not b.out and ticks < 20:
        s.step()
        ticks += 1
    assert ticks >= 8, ticks                   # 64 rows in chunks of 8
    assert len(a_tokens) - a_before >= (ticks - 1) * 4
    assert b.ttft is not None and b.ttft > 0


def test_mixed_per_request_sampling(model):
    """Greedy slots stay token-exact beside a sampled one; the sampled one
    emits its budget of valid tokens."""
    cfg, params = model
    want = engine_outputs(cfg, params)
    s = sched(cfg, params)
    done = {}
    s.submit(PROMPTS[0], max_new_tokens=N_NEW, temperature=0.0,
             on_done=lambda o: done.setdefault(0, o))
    s.submit(PROMPTS[1], max_new_tokens=N_NEW, temperature=0.8, top_p=0.9,
             on_done=lambda o: done.setdefault(1, o))
    s.submit(PROMPTS[2], max_new_tokens=N_NEW, temperature=0.0,
             on_done=lambda o: done.setdefault(2, o))
    s.run()
    assert done[0] == want[0] and done[2] == want[2]
    assert len(done[1]) == N_NEW
    assert all(0 <= t < cfg.vocab_size for t in done[1])


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.int8])
def test_prefix_cache_token_exact(model, cache_dtype):
    """A request sharing a 40-token prefix with a leased slot copies those
    rows (scale planes too for int8) and emits exactly what it emits
    without the prefix cache."""
    cfg, params = model
    shared = list(np.random.default_rng(5).integers(1, 250, size=40))

    def go(prefix_min):
        s = sched(cfg, params, max_ctx=128, cache_dtype=cache_dtype,
                  prefix_cache_min=prefix_min)
        done = {}
        lease = s.new_conversation()
        s.submit(shared + [3, 9], max_new_tokens=6, lease=lease,
                 on_done=lambda o: done.setdefault("a", o))
        s.run()
        s.submit(shared + [11, 4, 8], max_new_tokens=8,
                 on_done=lambda o: done.setdefault("b", o))
        s.run()
        return done, s

    plain, s_plain = go(0)
    forked, s_pc = go(16)
    assert s_plain.prefix_hits == 0
    assert s_pc.prefix_hits == 1 and s_pc.prefix_tokens_saved == 40
    assert forked == plain


def test_prefix_cache_ignores_short_and_free(model):
    cfg, params = model
    s = sched(cfg, params, max_batch=2, max_ctx=128, prefix_cache_min=16)
    run(s, [[5] * 40], n_new=4)      # no lease: the slot's rows die
    run(s, [[5] * 40 + [9]], n_new=4)
    assert s.prefix_hits == 0


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.int8])
def test_speculative_greedy_parity(model, cache_dtype):
    """Batched speculation (k drafts per slot verified in one t_q = k+1
    forward) emits exactly the plain batched scheduler's tokens."""
    cfg, params = model
    prompts = [[5, 9, 5, 9, 5, 9, 5], [1, 5, 9], [7, 3, 11, 13]]
    want = run(sched(cfg, params, cache_dtype=cache_dtype), prompts)
    s = sched(cfg, params, cache_dtype=cache_dtype, speculative_k=3)
    got = run(s, prompts)
    assert got == want
    assert s.spec_proposed > 0 and 0 <= s.spec_accepted <= s.spec_proposed


def test_speculative_mixed_sampling(model):
    """A greedy and a sampled request share a speculative batch: the greedy
    one stays token-exact, the sampled one (rejection sampling) emits its
    budget."""
    cfg, params = model
    want = run(sched(cfg, params), [[5, 9, 5, 9, 5]])[0]
    s = sched(cfg, params, seed=5, speculative_k=4)
    done = {}
    s.submit([5, 9, 5, 9, 5], max_new_tokens=N_NEW,
             on_done=lambda o: done.setdefault("g", o))
    s.submit([2, 4, 8], max_new_tokens=N_NEW, temperature=0.9, top_p=0.8,
             on_done=lambda o: done.setdefault("s", o))
    s.run()
    assert done["g"] == want
    assert len(done["s"]) == N_NEW


def test_speculative_context_guard(model):
    """A slot whose context cannot hold another speculative chunk
    finishes instead of writing past S."""
    cfg, params = model
    s = sched(cfg, params, max_batch=2, max_ctx=32, speculative_k=3)
    out = run(s, [[1, 5, 9, 2, 7, 4]], n_new=64)[0]
    assert out is not None and len(out) >= 1
    assert all(sl.pos <= s.S for sl in s.slots)


def test_rejects_unsupported_configurations(tmp_path, model):
    """The JAX scheduler's validation errors, message for message."""
    cfg, params = model
    with pytest.raises(ValueError, match="paged-only"):
        sched(cfg, params, cache_dtype="int4")
    # head_dim 16: no paged pool
    with pytest.raises(ValueError, match="fast kernel"):
        sched(cfg, params, pool_tokens=256)
    assert not paged_supported(cfg)
    wide, wp = build(tmp_path, ModelType.GEMMA, QuantType.Q8_0, seed=2,
                     dim=128, hidden_dim=256, n_heads=2, n_kv_heads=1,
                     head_dim=128, seq_len=256)
    # int4 pair packing needs an even kv-head count at head_dim 128
    with pytest.raises(ValueError, match="kv-head"):
        sched(wide, wp, cache_dtype="int4", pool_tokens=256, page_size=64)
    assert not paged_supported(wide, "int4") and paged_supported(wide)
    with pytest.raises(ValueError, match="page_size"):
        sched(wide, wp, pool_tokens=256, page_size=4)
    with pytest.raises(ValueError, match="page_size"):
        sched(wide, wp, pool_tokens=256, page_size=64, prefill_chunk=100)
    with pytest.raises(ValueError, match="exceeds max context"):
        sched(cfg, params, max_ctx=16).submit(list(range(1, 20)))
    assert auto_pool_tokens(8, 8192) == 49152
    assert auto_pool_tokens(4, 100, 64) == 320


def test_scheduler_thread_ends_requests_when_a_step_fails(model):
    """A step that raises on the SchedulerThread ends every request with
    the error (a connection waiting on one does not hang), and later
    submits raise it."""
    import threading

    from lmrs_tpu_torch.serve.scheduler import SchedulerThread

    cfg, params = model
    s = sched(cfg, params)

    def broken():
        raise RuntimeError("planted")

    s.step = broken
    done = threading.Event()
    thread = SchedulerThread(s)
    try:
        req = thread.submit(PROMPTS[0], max_new_tokens=4,
                            on_done=lambda o: done.set())
        assert done.wait(30)
        assert "planted" in req.error
        with pytest.raises(RuntimeError, match="stopped"):
            thread.submit(PROMPTS[1])
    finally:
        thread.shutdown()


def test_matches_the_jax_scheduler(tmp_path):
    """The slice as a whole: the port's BatchScheduler against the JAX
    BatchScheduler on the same tiny model file and prompts, greedy, f32
    cache, staggered over two slots."""
    import jax.numpy as jnp

    import lmrs_tpu.io.lmrs as jl
    from lmrs_tpu.io.params import params_from_lmrs as jax_params
    from lmrs_tpu.serve.scheduler import BatchScheduler as JaxScheduler

    cfg, params = build(tmp_path, seed=4)
    path = str(tmp_path / "m4_LLAMA.lmrs")
    jf = jl.read_lmrs(path)
    js = JaxScheduler(jf.cfg, jax_params(jf), max_batch=2, max_ctx=64,
                      cache_dtype=jnp.float32, prefill_chunk=8,
                      decode_chunk=4, min_attn_bucket=32, temperature=0.0)
    want = run(js)
    got = run(sched(cfg, params, max_batch=2))
    # first near-tie of each prompt's plain greedy run (module note)
    n_cmp = 0
    for p, g, w in zip(PROMPTS, got, want):
        eng = Engine(cfg, params, device="cpu", cache_dtype=torch.float32)
        logits = eng.prefill(p)
        n_eq = N_NEW
        for step in range(N_NEW):
            top = torch.topk(logits, 2).values
            if float(top[0] - top[1]) < 1e-2 * float(logits.abs().max()):
                n_eq = step
                break
            logits = eng.decode_step(int(logits.argmax()))
        assert g[:n_eq] == w[:n_eq], (g, w, n_eq)
        n_cmp += n_eq
    assert n_cmp >= 5          # the comparison is not empty
