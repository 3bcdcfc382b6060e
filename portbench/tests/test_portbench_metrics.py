"""Metric arithmetic on synthetic records, counters and traces."""

import math
import types

import pytest
import torch

from portbench import readings, spec, trace
from portbench.drive import Rec
from portbench.traffic import TurnSpec

torch.set_num_threads(1)


def reader(name):
    return spec._load_reader(name, spec.HERE)


def rec(due, times, done=None, error=None):
    r = Rec(spec=TurnSpec(0, 0, [1], 4, True, False), context=[], due=due)
    r.times = list(times)
    r.done, r.error = done, error
    return r


def ctx(recs, c0=None, c1=None, **kw):
    zero = dict(tokens_emitted=0, decode_seconds=0.0, decode_steps=0,
                prefix_hits=0, prefix_tokens_saved=0, pages_peak=0,
                admitted_prompt_tokens=0)
    return readings.Context(cfg=None, conf={}, mix={"batch": 4},
                            card="cpu", w0=10.0, w1=20.0, setup_s=3.5,
                            recs=recs, c0=c0 or zero, c1=c1 or zero, **kw)


def test_p90_nearest_rank_with_failures():
    assert readings.p90(list(range(1, 11))) == 9
    assert readings.p90([1.0] * 9 + [math.inf]) == 1.0
    assert readings.p90([1.0] * 8 + [math.inf] * 2) == math.inf
    assert readings.p90([]) is None


def test_end_to_end_readers():
    recs = [
        rec(9.0, [9.5, 10.5, 11.5], done=11.5),          # 2 tokens inside
        rec(12.0, [12.2, 12.4, 12.6, 12.8], done=12.8),  # tpot 200 ms
        rec(15.0, [], done=16.0, error="kv page pool exhausted"),
        rec(19.0, [19.9, 20.5], done=None),              # ends after w1
    ]
    c = ctx(recs)
    assert reader("output_tok_s")(c) == pytest.approx((2 + 4 + 1) / 10.0)
    # turns done inside the window: 1000, 200 and a failure (inf)
    assert reader("tpot_p90_ms")(c) == math.inf
    # turns due inside: 200 ms, a failure, 900 ms
    assert reader("ttft_p90_ms")(c) == math.inf
    c.recs = recs[:2] + recs[3:]
    assert reader("ttft_p90_ms")(c) == pytest.approx(900.0)
    assert reader("tpot_p90_ms")(c) == pytest.approx(1000.0)
    assert reader("setup_s")(c) == 3.5


def test_counter_readers():
    c0 = dict(tokens_emitted=0, decode_seconds=1.0, decode_steps=100,
              prefix_hits=1, prefix_tokens_saved=500, pages_peak=0,
              admitted_prompt_tokens=7000)
    c1 = dict(c0, decode_seconds=4.0, decode_steps=160,
              prefix_tokens_saved=2500, admitted_prompt_tokens=9500)
    c = ctx([], c0, c1, recorder=types.SimpleNamespace())
    assert reader("decode_step_ms")(c) == pytest.approx(50.0)
    assert reader("prefix_hit_share")(c) == pytest.approx(80.0)
    c.recorder = None                      # an untraced run reads nothing
    assert reader("prefix_hit_share")(c) is None


def chrome(events):
    out = []
    for cat, name, ts, dur, grid in events:
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if grid:
            e["args"] = {"grid": grid}
        out.append(e)
    return {"traceEvents": out}


def test_trace_union_spans_and_breakdown():
    ev = [("kernel", "void flash_kernel<128, (Cache)0, 16>(float)", 0, 100,
           [2, 32, 4]),
          ("kernel", "flash_merge_kernel(float const*)", 60, 60, [1, 1, 1]),
          ("kernel", "void qgemm_kernel<0>(x)", 130, 50, [1, 1, 1]),
          ("kernel", "void flash_kernel<128, (Cache)0, 64>(float)", 300, 40,
           [4, 32, 1]),                     # a prefill call (grid z = 1)
          ("kernel", "flash_merge_kernel(float const*)", 345, 10, [1, 1, 1]),
          ("gpu_memcpy", "Memcpy DtoH", 400, 20, None),
          ("user_annotation", "scheduler.step", 0, 500, None),
          ("user_annotation", "scheduler.emit", 190, 50, None)]
    tr = trace.parse(chrome(ev), window_s=500e-6)
    # [0, 120] [130, 180] [300, 340] [345, 355] [400, 420]
    assert tr.busy_s() == pytest.approx(240e-6)
    c = ctx([], trace=tr)
    assert reader("device_idle_share.decode")(c) == pytest.approx(52.0)
    # the decode call (grid z = batch 4) from its start to its merge's end
    assert readings.decode_attention_span_s(c) == pytest.approx(120e-6)
    b = trace.breakdown(tr)
    assert b["device_ops"][0][0] == "flash_kernel<128, (Cache)0, 16>"
    gaps = dict(b["idle_gaps"])
    assert gaps["scheduler.emit"] == pytest.approx(120e-6)    # 180-300
    assert gaps["scheduler.step"] == pytest.approx(
        10e-6 + 5e-6 + 45e-6)


def test_readers_without_a_trace_read_nothing():
    c = ctx([])
    for name in ("step_mfu.decode", "attn_roofline.decode",
                 "device_idle_share.decode"):
        assert reader(name)(c) is None
