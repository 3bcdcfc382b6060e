"""The port's host spans (`lmrs_tpu_torch.tracing`, `BatchScheduler.spans`)
on a tiny paged scheduler on the CPU: the ring holds the documented spans
nested inside the ticks, with the requests' ids and the lanes and steps
they count; `decode_seconds` is the sum of the `sched.decode` spans; each
request's times are ordered; under a CPU `torch.profiler` the spans and
the batched forward's stages are the trace's `user_annotation` events and
their ring records are flagged, and without one no stage is opened; a
full ring drops its oldest records.  Also the scheduler's lease race: a
conversation leased from an `on_done` callback onto the slot just freed
starts at position 0."""

import json
from collections import deque

import pytest
import torch

from lmrs_tpu_torch import tracing
from lmrs_tpu_torch.config import ModelType, QuantType
from test_torch_scheduler import build, sched

torch.set_num_threads(1)

KW = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=2, n_kv_heads=2,
          head_dim=128, vocab_size=256, seq_len=256)
SCHED_NAMES = {"sched.tick", "sched.admit", "sched.prefix", "sched.prefill",
               "sched.first_token", "sched.decode", "sched.decode.launch",
               "sched.decode.read", "sched.emit"}
STAGES = {"fwd.embed", "fwd.qkv", "fwd.kv_write", "fwd.attn", "fwd.post",
          "fwd.head", "sample"}
DOC = list(range(1, 30))          # a shared 29-token prefix


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return build(tmp_path_factory.mktemp("tracing"), ModelType.GEMMA,
                 QuantType.Q8_0, seed=3, **KW)


def paged(cfg, params, **kw):
    base = dict(max_ctx=128, page_size=64, pool_tokens=6 * 128,
                prefix_cache_min=8)
    base.update(kw)
    return sched(cfg, params, **base)


def drive(s):
    """Staggered traffic with a prefix hit: one request, then (once its
    prompt is resident) two that share its first 29 tokens and one that
    shares none.  Returns the requests and, per decode chunk, the lanes
    holding a request at its first forward (counted on the forward's
    side)."""
    lanes, first = [], [True]
    orig_fwd, orig_step = s._fwd_b, s.step

    def fwd_b(x, p, t_q=1, table=None, logit_idx=None, want_logits=True):
        if p.shape[0] == s.B and first[0]:       # a decode step
            first[0] = False
            lanes.append(sum(1 for sl in s.slots if sl.req is not None))
        return orig_fwd(x, p, t_q, table, logit_idx, want_logits)

    def step():
        first[0] = True
        orig_step()

    s._fwd_b, s.step = fwd_b, step
    reqs = [s.submit(DOC + [40], max_new_tokens=14)]
    for _ in range(5):
        s.step()
    reqs += [s.submit(DOC + [41, 42], max_new_tokens=9),
             s.submit(DOC + [43], max_new_tokens=6, temperature=0.8),
             s.submit([7, 3, 11, 13], max_new_tokens=7)]
    s.run()
    return reqs, lanes


def inside(child, parent):
    return parent.t0_ns <= child.t0_ns and child.t1_ns <= parent.t1_ns


def test_ring_holds_the_spans_in_ticks(model):
    cfg, params = model
    s = paged(cfg, params)
    reqs, lanes = drive(s)
    ring = list(s.spans)
    assert {r.name for r in ring} == SCHED_NAMES
    assert all(isinstance(r.t0_ns, int) and r.t0_ns <= r.t1_ns
               and not r.profiled for r in ring)
    ticks = [r for r in ring if r.name == "sched.tick"]
    for r in ring:
        if r.name != "sched.tick":
            assert sum(inside(r, t) for t in ticks) == 1, r
    decodes = [r for r in ring if r.name == "sched.decode"]
    for name in ("sched.decode.launch", "sched.decode.read"):
        kids = [r for r in ring if r.name == name]
        assert len(kids) == len(decodes)
        assert all(inside(k, d) and k.n == s.decode_chunk
                   for k, d in zip(kids, decodes))
    # a child is appended before its parent
    assert ring[-1].name == "sched.tick"
    # rids: the requests' own; whole-batch spans -1
    ids = {q.id for q in reqs}
    for r in ring:
        if r.name in ("sched.prefix", "sched.prefill", "sched.first_token"):
            assert r.rid in ids
        else:
            assert r.rid == -1
    firsts = [r.rid for r in ring if r.name == "sched.first_token"]
    assert sorted(firsts) == sorted(ids) and all(
        r.n == 1 for r in ring if r.name == "sched.first_token")
    # the prefix hits' forks and the prefill rows cover each prompt
    forked = {r.rid: r.n for r in ring if r.name == "sched.prefix"}
    assert forked[reqs[1].id] == forked[reqs[2].id] == len(DOC)
    assert forked[reqs[0].id] == forked[reqs[3].id] == 0
    assert s.prefix_tokens_saved == 2 * len(DOC)
    for q in reqs:
        rows = sum(r.n for r in ring
                   if r.name == "sched.prefill" and r.rid == q.id)
        assert rows + forked[q.id] == len(q.prompt)
    assert sum(r.n for r in ring if r.name == "sched.admit") == len(reqs)
    # decode: lanes holding a request, as the forward saw them
    assert [d.n for d in decodes] == lanes
    assert s.decode_steps == s.decode_chunk * len(decodes)
    assert s.decode_seconds == pytest.approx(
        sum((d.t1_ns - d.t0_ns) * 1e-9 for d in decodes), rel=1e-12)
    emitted = sum(r.n for r in ring if r.name == "sched.emit")
    assert emitted + len(firsts) == s.tokens_emitted == sum(
        len(q.out) for q in reqs)
    for q in reqs:
        assert q.submit_time <= q.admit_time <= q.first_time <= q.done_time
        assert q.ttft == q.first_time - q.submit_time


def test_ring_matches_the_speculative_chunk(model):
    cfg, params = model
    s = paged(cfg, params, speculative_k=3)
    reqs, lanes = drive(s)
    decodes = [r for r in s.spans if r.name == "sched.decode"]
    assert [d.n for d in decodes] == lanes
    assert s.decode_seconds == pytest.approx(
        sum((d.t1_ns - d.t0_ns) * 1e-9 for d in decodes), rel=1e-12)
    emitted = sum(r.n for r in s.spans if r.name == "sched.emit")
    assert emitted + len(reqs) == s.tokens_emitted


def annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    return [e["name"] for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_profiler_sees_spans_and_stages(model, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    cfg, params = model
    s = paged(cfg, params)
    s.submit(DOC + [40], max_new_tokens=12)
    for _ in range(5):
        s.step()
    before = len(s.spans)
    assert not tracing.profiling()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.profiling()
        s.submit(DOC + [41], max_new_tokens=6, temperature=0.8)
        s.run()
    assert not tracing.profiling()
    assert s.prefix_hits == 1
    names = annotations(prof, tmp_path)
    assert SCHED_NAMES | STAGES <= set(names)
    # each layer's four stages, once per layer of every batched forward
    fwd = names.count("fwd.embed")
    assert fwd > 0 and names.count("fwd.post") == cfg.n_layers * fwd
    ring = list(s.spans)
    assert all(r.profiled for r in ring[before:])
    assert not any(r.profiled for r in ring[:before])
    assert not any(r.name.startswith("fwd.") or r.name == "sample"
                   for r in ring)


def test_no_stage_without_a_profiler(model, monkeypatch):
    cfg, params = model
    opened = []
    real = torch.profiler.record_function

    def record_function(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    s = paged(cfg, params)
    drive(s)
    assert opened == []
    assert len(s.spans) > 0 and not any(r.profiled for r in s.spans)


def test_full_ring_drops_its_oldest_records(model):
    assert tracing.ring().maxlen == tracing.RING_SPANS
    ring = deque(maxlen=4)
    for i in range(10):
        with tracing.Span(ring, f"s{i}", n=i) as sp:
            sp.n += 1
    assert [r.name for r in ring] == ["s6", "s7", "s8", "s9"]
    assert [r.n for r in ring] == [7, 8, 9, 10]
    with pytest.raises(KeyError):
        with tracing.Span(ring, "raised"):
            raise KeyError("a span that raises is still recorded")
    assert ring[-1].name == "raised" and len(ring) == 4
    cfg, params = model
    s = paged(cfg, params)
    s.spans = deque(maxlen=16)
    drive(s)
    assert len(s.spans) == 16 and s.spans[-1].name == "sched.tick"
    full = paged(cfg, params)
    drive(full)
    assert len(full.spans) > 16
    assert [r.name for r in s.spans] == [r.name for r in full.spans][-16:]


@pytest.mark.parametrize("spec_k", [0, 3])
def test_lease_from_on_done_starts_at_zero(model, spec_k):
    """A request's on_done leases the slot its request just freed: the new
    conversation starts at pos 0, and its first turn gives what the same
    prompt gives on a fresh scheduler."""
    cfg, params = model
    s = paged(cfg, params, max_batch=1, speculative_k=spec_k)
    box = {}
    s.submit([5, 6, 7, 8, 9], max_new_tokens=6,
             on_done=lambda out: box.setdefault("lease",
                                                s.new_conversation()))
    s.run()
    lease = box["lease"]
    assert lease is not None and lease.slot_idx == 0
    assert s.slots[0].pos == 0
    turn = s.submit([1, 2, 3], max_new_tokens=8, lease=lease)
    s.run()
    fresh = paged(cfg, params, max_batch=1, speculative_k=spec_k)
    want = fresh.submit([1, 2, 3], max_new_tokens=8)
    fresh.run()
    assert turn.out == want.out
