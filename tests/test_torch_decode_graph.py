"""The batched decode step as a CUDA graph (`models.transformer.
DecodeGraph`, engaged by `serve.scheduler.BatchScheduler._fwd_b`).

On the CPU (tier-1): which forwards engage it.  A CPU scheduler holds no
graph and counts no capture or replay; with a recording stand-in in the
graph's place, only the decode steps of every lane reach it, while prefill
chunks, image rows, speculative verify windows and mesh forwards stay
eager, and the ring's `sched.decode.graph` spans count the replays inside
their chunk's `sched.decode.launch`; and a graph's kernel nodes, by the
names libcuda gives them, count under the wrappers that count their
launches (`kernels.graph_launches`).

On the card (marked `gpu`, skipped without a CUDA device; the decision is
taken in a fixture): the scheduler's graph steps against the same
scheduler with the graph taken out (its decode steps eager
`forward_batched` calls on the same pool), over several chunks between
which a page is added to the table, a prefix forks, one lane finishes and
others join: every decode step's logits bit for bit on the lanes that
hold a request, greedy and sampled tokens equal (the sampling stays
eager, on the same generator), sampled draws that differ from step to
step, the static buffers at one address, one capture (a step on another
cache raises), the graph's kernel nodes the very kernels that the eager
step runs by the profiler's device trace, and each replay's launch
counts, read from those nodes, equal to the eager step's; at bf16 and
int8 pools, Q4_0 and Q8_0 weights, and the contiguous per-slot cache.
Two schedulers stepped from threads of their own at once, as dp replicas
are, count in the process what they count one after the other.  Also
that the device trace of a profiler started after the capture holds the
replayed kernels with their grids (the benchmark's readers count them).
    python -m pytest tests/test_torch_decode_graph.py -m gpu
This file imports no JAX.
"""

import json
import threading
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lmrs_tpu_torch.config import ModelType, QuantType
from lmrs_tpu_torch.kernels import (graph_launches, launches,
                                    reset_launches)
from lmrs_tpu_torch.kernels.cuda import demangle
from lmrs_tpu_torch.models.transformer import copy_rows, forward_batched
from test_torch_scheduler import build, sched

torch.set_num_threads(1)

KW = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=2, n_kv_heads=2,
          head_dim=128, vocab_size=256, seq_len=256)
DOC = list(range(1, 30))          # a shared 29-token prefix


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return build(tmp_path_factory.mktemp("graph"), ModelType.LLAMA,
                 QuantType.Q8_0, seed=4, **KW)


def make(cfg, params, kind, **kw):
    base = dict(max_ctx=128, prefix_cache_min=8)
    if kind != "contiguous":
        base.update(page_size=64, pool_tokens=8 * 128)
    if kind == "speculative":
        base.update(speculative_k=3)
    base.update(kw)
    return sched(cfg, params, **base)


class RecordingGraph:
    """Stands in for the scheduler's DecodeGraph on the CPU: runs the step
    eagerly and records each call."""

    def __init__(self, s):
        self.s = s
        self.captures = self.replays = 0
        self.calls = []

    def __call__(self, cache, x, pos, table=None):
        self.calls.append((tuple(x.shape), tuple(pos.shape)))
        self.replays += 1
        s = self.s
        return forward_batched(s.params, s.cfg, cache, x, pos, table=table,
                               w8a8=s.w8a8)


def record_forwards(s):
    """Wrap the instance's `_fwd_b`; returns the list it fills with each
    call's (t_q, rows, float rows, logit_idx, want_logits)."""
    calls = []
    orig = s._fwd_b

    def fwd_b(x, p, t_q=1, table=None, logit_idx=None, want_logits=True):
        calls.append((t_q, x.shape[0], x.dtype.is_floating_point, logit_idx,
                      want_logits))
        return orig(x, p, t_q, table, logit_idx, want_logits)

    s._fwd_b = fwd_b
    return calls


def traffic(s, images=True):
    """A request, then (once its prompt is resident) one that forks its
    prefix, one sampled and one unrelated; with `images`, a leased
    conversation whose image rows are prefilled before its turn.  Returns
    each request's tokens."""
    reqs = [s.submit(DOC + [40], max_new_tokens=14)]
    for _ in range(5):
        s.step()
    reqs += [s.submit(DOC + [41, 42], max_new_tokens=9),
             s.submit(DOC + [43], max_new_tokens=6, temperature=0.8),
             s.submit([7, 3, 11, 13], max_new_tokens=7)]
    s.run()
    if images:
        lease = s.new_conversation()
        rows = torch.randn(20, s.cfg.dim,
                           generator=torch.Generator().manual_seed(2))
        s.prefill_embeds(lease, rows)
        reqs.append(s.submit([5, 6, 7], max_new_tokens=5, lease=lease))
        s.run()
    return [r.out for r in reqs]


def test_cpu_scheduler_holds_no_graph(model):
    cfg, params = model
    s = make(cfg, params, "paged")
    traffic(s)
    assert s._graph is None
    assert s.decode_graph_captures == s.decode_graph_replays == 0
    assert "sched.decode.graph" not in {r.name for r in s.spans}


@pytest.mark.parametrize("kind", ["paged", "contiguous", "speculative"])
def test_only_decode_steps_engage(model, kind):
    """With the stand-in in the graph's place: the decode steps (t_q 1,
    the (B,) token ids, all logits) reach it, nothing else does, and the
    tokens are the eager scheduler's."""
    cfg, params = model
    want = traffic(make(cfg, params, kind), images=kind != "contiguous")
    s = make(cfg, params, kind)
    s._graph = graph = RecordingGraph(s)
    calls = record_forwards(s)
    assert traffic(s, images=kind != "contiguous") == want
    decode = [c for c in calls if c == (1, s.B, False, None, True)]
    if kind == "speculative":
        assert not decode and graph.replays == 0
        assert {c[0] for c in calls} >= {s.spec_k + 1}    # verify windows
    else:
        assert decode and graph.replays == len(decode)
        assert graph.calls == [((s.B,), (s.B,))] * len(decode)
    # what stayed eager: prefill chunks, and paged, the image's rows
    eager = [c for c in calls if c not in decode]
    if kind != "contiguous":
        assert any(c[0] > 1 for c in eager)
        assert any(c[2] and not c[4] for c in eager)
    # one graph span inside each plain chunk's launch, n its replays
    launch = [r for r in s.spans if r.name == "sched.decode.launch"]
    spans = [r for r in s.spans if r.name == "sched.decode.graph"]
    if kind == "speculative":
        assert not spans
    else:
        assert len(spans) == len(launch)
        for g, la in zip(spans, launch):
            assert la.t0_ns <= g.t0_ns and g.t1_ns <= la.t1_ns
            assert g.n == la.n
        assert sum(g.n for g in spans) == graph.replays


def test_mesh_forwards_stay_eager(model):
    """A mesh scheduler's forwards go to the mesh, ahead of any graph."""
    cfg, params = model
    want = traffic(make(cfg, params, "paged"), images=False)
    s = make(cfg, params, "paged")
    s._graph = graph = RecordingGraph(s)
    to_mesh = []

    def mesh_forward(cid, x, p, t_q, table, logit_idx, w8a8, want_logits):
        to_mesh.append(t_q)
        return forward_batched(params, cfg, s.cache, x, p, t_q=t_q,
                               table=table, logit_idx=logit_idx, w8a8=w8a8,
                               want_logits=want_logits)

    s.mesh, s._cid = types.SimpleNamespace(
        forward_batched=mesh_forward,
        copy_rows=lambda cid, kind, src, dst, n: copy_rows(s.cache, kind,
                                                           src, dst, n)), 0
    assert traffic(s, images=False) == want
    assert 1 in to_mesh and graph.calls == []


# kernel functions in libcuda's (mangled) names, of the csrc templates'
# shapes, and the wrapper whose launch count counts each ("paged" for the
# flash template's split pass, which a graph of the paged step counts
# under J); a torch kernel and the second launch of K or L count nowhere
NODES = [
    ("_ZN9lmrs_sm9012_GLOBAL__N_112qgemm_kernelILNS0_5QuantE0ELi64ELNS0_3E"
     "piE0EEEv14CUtensorMap_stPKfPfiNS0_7GluArgsE", "q4_gemm"),
    ("_ZN9lmrs_sm9012_GLOBAL__N_112qgemm_kernelILNS0_5QuantE1ELi128ELNS0_3"
     "EpiE0EEEv14CUtensorMap_stPKfPfiNS0_7GluArgsE", "q8_gemm"),
    ("_ZN9lmrs_sm9012_GLOBAL__N_112qgemm_kernelILNS0_5QuantE1ELi16ELNS0_3E"
     "piE1EEEv14CUtensorMap_stPKfPfiNS0_7GluArgsE", "ffn_fused"),
    ("_ZN9lmrs_sm9012_GLOBAL__N_112qgemm_kernelILNS0_5QuantE1ELi16ELNS0_3E"
     "piE2EEEv14CUtensorMap_stPKfPfiNS0_7GluArgsE", None),
    ("_ZN12_GLOBAL__N_113ffn_xe_kernelILi0ELi16ELi0EEEv14CUtensorMap_stPK4"
     "bf16PKfPv", "ffn_fused_xe"),
    ("_ZN12_GLOBAL__N_113ffn_xe_kernelILi1ELi16ELi1EEEv14CUtensorMap_stPK4"
     "bf16PKfPv", None),
    ("_ZN12_GLOBAL__N_112flash_kernelILi128ELNS_5CacheE1ELi64EEEvPKfPKviNS"
     "_4WalkENS_5SplitE", "paged"),
    ("_ZN12_GLOBAL__N_118flash_merge_kernelEPKfS1_i", "flash_merge"),
    ("_ZN12_GLOBAL__N_118q4_gemv_mma_kernelILi16ELi3EEEvPKfPKhi", "q4_gemv"),
    ("_ZN12_GLOBAL__N_114q8_gemv_kernelILi4EEEvPKfPKai", "q8_gemv"),
    ("_ZN12_GLOBAL__N_117q8_gemv_i8_kernelILi32EEEv14CUtensorMap_stPKfNS_4"
     "PlanE", "q8_gemv_i8"),
    ("_ZN12_GLOBAL__N_119q8_act_quant_kernelILi1EEEvPKfPaPfi", None),
    ("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIf"
     "EESt5arrayIPcLm1EEEEviT0_T1_", None)]


@pytest.mark.parametrize("mangled,wrapper", NODES)
def test_graph_launches_count_as_the_wrappers(mangled, wrapper):
    """A graph's kernel nodes (demangled as the profiler names them) count
    under the wrapper that counts their launches, three nodes three."""
    name = demangle(mangled.encode())
    assert name != mangled and name.count("(") >= 1
    got = graph_launches({name: 3}, "flash_attention_paged")
    if wrapper == "paged":
        wrapper = "flash_attention_paged"
    assert got == ({} if wrapper is None else {wrapper: 3})


def test_graph_launches_of_a_step():
    """A step's nodes: the split pass counts under the wrapper given for
    the flash template (I without a table, J with one)."""
    names = {demangle(m.encode()): i + 1 for i, (m, _) in enumerate(NODES)}
    got = graph_launches(names, "flash_attention_batched")
    assert got == {"q4_gemm": 1, "q8_gemm": 2, "ffn_fused": 3,
                   "ffn_fused_xe": 5, "flash_attention_batched": 7,
                   "flash_merge": 8, "q4_gemv": 9, "q8_gemv": 10,
                   "q8_gemv_i8": 11}


# ---- on the card -------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    return torch.device("cuda")


def card_model(tmp_path, quant):
    """A small Llama with kernel-legal widths (gs 128, head_dim 128 for
    the pool's lanes), on the card."""
    from lmrs_tpu_torch.config import ModelConfig
    from lmrs_tpu_torch.io.lmrs import read_lmrs
    from lmrs_tpu_torch.io.params import params_from_lmrs
    from lmrs_tpu_torch.io.synthetic import write_synthetic_lmrs

    cfg = ModelConfig.make(
        ModelType.LLAMA, dim=512, hidden_dim=1024, n_layers=2, n_heads=4,
        head_dim=128, n_kv_heads=2, vocab_size=1024, seq_len=512,
        rms_norm_eps=1e-5, rope_theta=10000.0, quant=QuantType[quant],
        group_size=128)
    path = str(tmp_path / f"g_{quant}.lmrs")
    write_synthetic_lmrs(path, cfg, seed=3, scale=0.05)
    f = read_lmrs(path)
    return f.cfg, params_from_lmrs(f, device="cuda")


def card_sched(cfg, params, cache, paged=True):
    from lmrs_tpu_torch.serve.scheduler import BatchScheduler

    kw = dict(page_size=64, pool_tokens=24 * 64) if paged else {}
    return BatchScheduler(cfg, params, max_batch=12, max_ctx=384,
                          cache_dtype=cache, prefill_chunk=32,
                          decode_chunk=8, temperature=0.0, seed=5,
                          prefix_cache_min=16, device="cuda", **kw)


def card_traffic(s, steps):
    """Deterministic traffic: six prompts (two sampled hot, one that ends
    after 10 tokens), then a prompt forking the first one's 40-token
    prefix, then two that join; each decode step's logits of the lanes
    that hold a request (cloned before the next step overwrites them) and
    the address they were returned at go to `steps`.  A lane without a
    request is left out: a paged lane past its pages writes and reads
    the trash page, which every such lane writes at once, so its logits
    depend on which write lands last."""
    orig = s._fwd_b

    def fwd_b(x, p, t_q=1, table=None, logit_idx=None, want_logits=True):
        out = orig(x, p, t_q, table, logit_idx, want_logits)
        if t_q == 1 and x.shape[0] == s.B and want_logits:
            live = [i for i, sl in enumerate(s.slots) if sl.req is not None]
            steps.append((out[live].clone(), out.data_ptr()))
        return out

    s._fwd_b = fwd_b
    g = torch.Generator().manual_seed(7)

    def prompt(n):
        return torch.randint(0, s.cfg.vocab_size, (n,), generator=g).tolist()

    first = prompt(70)
    reqs = [s.submit(first, max_new_tokens=40)]
    reqs += [s.submit(prompt(n), max_new_tokens=40) for n in (20, 45, 90)]
    reqs += [s.submit(prompt(33), max_new_tokens=40, temperature=1.5,
                      top_p=0.95),
             s.submit(prompt(50), max_new_tokens=40, temperature=1.5,
                      top_p=1.0),
             s.submit(prompt(25), max_new_tokens=10)]
    for _ in range(4):
        s.step()
    reqs.append(s.submit(first[:40] + prompt(9), max_new_tokens=30))
    for _ in range(2):
        s.step()
    reqs += [s.submit(prompt(n), max_new_tokens=24) for n in (12, 60)]
    s.run()
    for r in reqs:
        assert r.error is None, r.error
    return reqs


@pytest.mark.gpu
@pytest.mark.parametrize("quant,cache,paged", [
    ("Q4_0", "bfloat16", True), ("Q4_0", "int8", True),
    ("Q8_0", "int8", True), ("Q8_0", "bfloat16", True),
    ("Q4_0", "bfloat16", False), ("Q4_0", "int8", False)])
def test_graph_steps_equal_eager_steps_on_card(cuda_device, tmp_path, quant,
                                               cache, paged):
    cfg, params = card_model(tmp_path, quant)
    runs = {}
    for mode in ("graph", "eager"):
        s = card_sched(cfg, params, cache, paged)
        if mode == "eager":
            s._graph = None
        steps = []
        reqs = card_traffic(s, steps)
        torch.cuda.synchronize()
        runs[mode] = (s, reqs, steps)
    s, reqs, steps = runs["graph"]
    _, e_reqs, e_steps = runs["eager"]
    assert len(steps) == len(e_steps) > 16
    for i, ((a, _), (b, _)) in enumerate(zip(steps, e_steps)):
        assert torch.equal(a, b), f"decode step {i}"
    assert [r.out for r in reqs] == [r.out for r in e_reqs]
    assert s.prefix_hits >= 1 and s.decode_graph_captures == 1
    assert s.decode_graph_replays == len(steps) - 1
    if paged:
        assert s.pages_peak > 7     # lanes grew past their first pages
    # sampled lanes: draws that change from step to step
    for r in reqs[4:6]:
        assert len(set(r.out)) > 1, r.out
    # the static buffers: every replay returned the one logits buffer, and
    # the inputs kept their addresses
    dg = s._graph
    assert {ptr for _, ptr in steps[1:]} == {dg._logits.data_ptr()}
    x_ptr, p_ptr = dg._x.data_ptr(), dg._pos.data_ptr()
    # a replay launches what the eager step launches; every lane on a
    # page of its own
    toks = torch.arange(s.B, device="cuda")
    pos = torch.full((s.B,), 10, dtype=torch.int32, device="cuda")
    table = None
    if paged:
        s._table[:] = 0
        s._table[:, 0] = range(1, s.B + 1)
        s._table_dirty = True
        s._table_sync()
        table = s._table_dev
    counts = {}
    for mode in ("graph", "eager"):
        reset_launches()
        with torch.no_grad(), profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            # well inside the trace's window: a step launched as it opens
            # can lose its first kernels from it
            torch.cuda.synchronize()
            time.sleep(0.2)
            if mode == "graph":
                out = s._fwd_b(toks, pos, table=table)
            else:
                out = forward_batched(params, cfg, s.cache, toks, pos,
                                      table=table)
            torch.cuda.synchronize()
            time.sleep(0.2)
        counts[mode] = launches()
        counts[mode + "_logits"] = out.clone()
        counts[mode + "_kernels"] = device_kernels(prof)
    # the graph's nodes are the eager step's kernels (a replay's own trace
    # is not compared: on the card it lost a graph's first kernels)
    assert dg.kernels == counts["eager_kernels"]
    assert dg.launches == {k: n for k, n in counts["eager"].items() if n}
    assert counts["graph"] == counts["eager"]
    assert sum(counts["graph"].values()) > 0
    assert torch.equal(counts["graph_logits"], counts["eager_logits"])
    assert (dg._x.data_ptr(), dg._pos.data_ptr()) == (x_ptr, p_ptr)
    # a step on a cache at another address raises
    from lmrs_tpu_torch.models.transformer import KVCache

    s.cache = KVCache(*(None if t is None else t.clone()
                        for t in (s.cache.k, s.cache.v, s.cache.k_scale,
                                  s.cache.v_scale)))
    with pytest.raises(RuntimeError, match="another cache"):
        s._fwd_b(toks, pos, table=table)
    assert s.decode_graph_captures == 1


def device_kernels(prof):
    """The kernels of a profiler's device trace by name."""
    out = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith(("Memcpy", "Memset"))):
            out[e.name] = out.get(e.name, 0) + 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_replicas_on_threads_count_their_own_steps_on_card(
        cuda_device, tmp_path, cache):
    """dp replicas step from threads of their own, so one captures while
    another prefills, decodes or captures: the process's launch counts
    over two schedulers stepped at once equal those of the same two
    stepped one after the other, and each graph's launches a replay
    equal one eager step's."""
    cfg, params = card_model(tmp_path, "Q4_0")
    totals = []
    for together in (False, True):
        scheds = [card_sched(cfg, params, cache) for _ in range(2)]
        reset_launches()
        if together:
            errors = []

            def drive(s):
                try:
                    card_traffic(s, [])
                except BaseException as e:       # noqa: BLE001
                    errors.append(e)

            threads = [threading.Thread(target=drive, args=(s,))
                       for s in scheds]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert not errors, errors
        else:
            for s in scheds:
                card_traffic(s, [])
        torch.cuda.synchronize()
        totals.append(launches())
        assert all(s.decode_graph_captures == 1 for s in scheds)
    assert totals[0] == totals[1]
    toks = torch.arange(scheds[0].B, device="cuda")
    pos = torch.full((scheds[0].B,), 10, dtype=torch.int32, device="cuda")
    for s in scheds:
        reset_launches()
        with torch.no_grad():
            forward_batched(params, cfg, s.cache, toks, pos,
                            table=s._table_dev)
        torch.cuda.synchronize()
        assert s._graph.launches == {k: n for k, n in launches().items()
                                     if n}


@pytest.mark.gpu
def test_profiler_sees_the_replayed_kernels_on_card(cuda_device, tmp_path):
    """The benchmark's traced run starts its profiler after set-up, where
    the graph was captured: the replays' kernels, J's split pass with its
    grid over the batch among them, are in the device trace."""
    cfg, params = card_model(tmp_path, "Q4_0")
    s = card_sched(cfg, params, "bfloat16")
    toks = torch.arange(s.B, device="cuda")
    pos = torch.full((s.B,), 100, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        s._fwd_b(toks, pos, table=s._table_dev)        # eager, capture
        torch.cuda.synchronize()
        path = tmp_path / "trace.json"
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                s._fwd_b(toks, pos, table=s._table_dev)
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
    assert s.decode_graph_replays == 3
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    split = [e for e in kernels if "flash_kernel<" in e["name"]
             and (e.get("args") or {}).get("grid", [0, 0, 0])[2] == s.B]
    merge = [e for e in kernels if "flash_merge_kernel" in e["name"]]
    assert len(split) == len(merge) == 3 * cfg.n_layers, \
        sorted({e["name"][:60] for e in kernels})
