"""The benchmark's readers of the port's own spans and request times
(`portbench/spans.py`, `decode_launch_ms`, `decode_lane_share`,
`queue_wait_p90_ms`, `prefill_p90_ms`, `decode_graph_share`): their
arithmetic on a synthetic ring and requests, the cut at the first
profiled span, no reading without a recorder, from a program that keeps
no ring or from a ring that overflowed; and a tiny traced CPU run of each
text cell, which reads the three that its cell lists."""

import types
from collections import deque

import pytest
import torch

from portbench import readings, spec

torch.set_num_threads(1)

W0, W1 = 10.0, 20.0
NEW = ("decode_launch_ms", "decode_lane_share", "queue_wait_p90_ms",
       "prefill_p90_ms")


def reader(name):
    return spec._load_reader(name, spec.HERE)


def ns(t):
    return round(t * 1e9)


def span(name, t0, t1, n=0, rid=-1, profiled=False):
    return (name, ns(t0), ns(t1), rid, n, profiled)


def chunk(t0, launch, read, lanes, steps=8, profiled=False, graph=None):
    """One decode chunk's records, in the order the port appends them
    (children first); with `graph`, a `sched.decode.graph` span of that
    many replays inside the launch."""
    t1 = t0 + launch + read
    inner = [] if graph is None else [
        span("sched.decode.graph", t0 + 0.001, t0 + launch - 0.001, graph,
             profiled=profiled)]
    return inner + [span("sched.decode.launch", t0, t0 + launch, steps,
                         profiled=profiled),
            span("sched.decode.read", t0 + launch, t1, steps,
                 profiled=profiled),
            span("sched.decode", t0, t1, lanes, profiled=profiled)]


def request(submit, admit, first):
    return types.SimpleNamespace(req=types.SimpleNamespace(
        submit_time=submit, admit_time=admit, first_time=first))


def ctx(records, recs=(), batch=4, sched=True):
    s = types.SimpleNamespace(B=batch)
    if sched:
        s.spans = deque(records)
    return readings.Context(
        cfg=None, conf={}, mix={"batch": batch}, card="cpu", w0=W0, w1=W1,
        setup_s=1.0, recs=list(recs), c0={}, c1={},
        recorder=types.SimpleNamespace(sched=s))


def synthetic():
    ring = [span("sched.tick", 1.0, 1.5)]              # set-up, before w0
    ring += chunk(9.97, 0.04, 0.02, lanes=4)          # ends after w0: in
    ring += chunk(11.0, 0.03, 0.01, lanes=2)
    ring += chunk(12.0, 0.05, 0.01, lanes=3, steps=4)
    ring += [span("sched.tick", 14.0, 14.5, profiled=True)]   # t_p = 14
    ring += chunk(15.0, 0.5, 0.5, lanes=4, profiled=True)
    recs = [request(10.5, 10.6, 10.9),      # admitted and first in range
            request(9.0, 9.5, 10.2),        # admitted before w0
            request(12.0, 13.0, 14.2),      # first token after t_p
            request(13.5, 14.1, 14.3),      # all after t_p
            types.SimpleNamespace(req=None)]
    return ring, recs


def test_readers_on_a_synthetic_ring():
    ring, recs = synthetic()
    c = ctx(ring, recs)
    # launches of the three chunks before t_p: 40 + 30 + 50 ms over 20
    # steps
    assert reader("decode_launch_ms")(c) == pytest.approx(120.0 / 20)
    # lanes x steps: 4 x 8 + 2 x 8 + 3 x 4 over 20 steps x 4 lanes
    assert reader("decode_lane_share")(c) == pytest.approx(
        100.0 * (32 + 16 + 12) / 80)
    # admitted in [10, 14): 100 and 1,000 ms
    assert reader("queue_wait_p90_ms")(c) == pytest.approx(1000.0)
    # first token in [10, 14): 300 and 700 ms
    assert reader("prefill_p90_ms")(c) == pytest.approx(700.0)


def test_no_profiled_span_reads_to_w1():
    ring, recs = synthetic()
    ring = [r[:5] + (False,) for r in ring]
    c = ctx(ring, recs)
    assert reader("decode_launch_ms")(c) == pytest.approx(
        (120.0 + 500.0) / 28)
    assert reader("prefill_p90_ms")(c) == pytest.approx(1200.0)
    assert reader("queue_wait_p90_ms")(c) == pytest.approx(1000.0)


@pytest.mark.parametrize("case", ["no recorder", "no ring", "overflow",
                                  "empty", "no decode"])
def test_readers_read_nothing(case):
    ring, recs = synthetic()
    if case == "no recorder":
        c = ctx(ring, recs)
        c.recorder = None
    elif case == "no ring":                 # a program without spans
        c = ctx(ring, [types.SimpleNamespace(
            req=types.SimpleNamespace(submit_time=10.5, first_time=None))],
            sched=False)
    elif case == "overflow":                # the oldest record is past w0
        c = ctx(ring[4:], recs)
    elif case == "empty":
        c = ctx([], recs)
    else:
        c = ctx([span("sched.tick", 1.0, 1.5)], [])
    for name in NEW:
        assert reader(name)(c) is None, name


@pytest.fixture(scope="module")
def runs():
    from portbench.run import run_cell
    from portbench.tests import tiny

    out = {}
    for name, mix in (("phi35-mini-q4.docqa-shared", tiny.tiny_docqa()),
                      ("phi35-mini-q4.chat-sessions", tiny.tiny_chat())):
        c = tiny.cell(name, tiny.tiny_conf(), mix)
        out[name] = run_cell(c, 2**33 + 11, 3.0, True, "cpu")
    return out


@pytest.mark.parametrize("name,want", [
    ("phi35-mini-q4.docqa-shared", ("decode_launch_ms", "decode_lane_share",
                                    "queue_wait_p90_ms")),
    ("phi35-mini-q4.chat-sessions", ("decode_launch_ms", "decode_lane_share",
                                     "prefill_p90_ms"))])
def test_traced_cpu_run_reads_the_spans(runs, name, want):
    r = runs[name]
    assert r["correct"], r["check"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(want) <= set(m)
    assert set(NEW) - set(want) <= set(NEW) - set(m)
    assert 0 < m["decode_launch_ms"] <= m["decode_step_ms"]
    assert 0 < m["decode_lane_share"] <= 100.0
    assert m.get("queue_wait_p90_ms", 1.0) > 0
    assert m.get("prefill_p90_ms", 1.0) > 0


def test_decode_graph_share_on_a_planted_ring():
    ring = [span("sched.tick", 1.0, 1.5)]
    ring += chunk(9.97, 0.04, 0.02, lanes=4, graph=7)   # the capture's
    ring += chunk(11.0, 0.03, 0.01, lanes=2, graph=8)
    ring += chunk(12.0, 0.05, 0.01, lanes=3, steps=4)   # a speculative one
    ring += [span("sched.tick", 14.0, 14.5, profiled=True)]
    ring += chunk(15.0, 0.5, 0.5, lanes=4, profiled=True, graph=8)
    # replays 7 + 8 of the 20 steps before t_p
    assert reader("decode_graph_share")(ctx(ring)) == pytest.approx(
        100.0 * 15 / 20)


def test_decode_graph_share_reads_nothing_without_graph_spans():
    ring, recs = synthetic()              # the parent's ring: no graph span
    assert reader("decode_graph_share")(ctx(ring, recs)) is None
    graph_after_tp = [span("sched.tick", 1.0, 1.5)] + chunk(
        11.0, 0.03, 0.01, lanes=2) + [
        span("sched.tick", 14.0, 14.5, profiled=True)] + chunk(
        15.0, 0.5, 0.5, lanes=4, profiled=True, graph=8)
    assert reader("decode_graph_share")(ctx(graph_after_tp)) is None
    c = ctx(ring, recs)
    c.recorder = None
    assert reader("decode_graph_share")(c) is None
