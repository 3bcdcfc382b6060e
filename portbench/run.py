"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (counted in `setup_s`): the port's
kernels built or loaded, the model's weights made on the card from the
seed, the batched server, a warm-up of every shape the traffic uses, and
the traffic's ramp.  Then the window: `--seconds` of the mix's load, timed
on the host clock (`--trace 0`), or the same with the device traced over
its last stretch of whole scheduler ticks (`--trace 1`, the per-layer
metrics).  After the window: the turns due in it are waited for (a minute
at most), the server's memory is read and freed, and the output check
runs the plain reference on a sample of greedy turns (`check.py`).

The last line of standard output is the result (`correct`, `attempted`,
`failed`, `metrics`, `device`, with `--trace 1` `breakdown`, and `check`:
each number compared with its limit), whose check numbers are also the
last lines of standard error.  Without a CUDA device, with fewer devices
than the cell asks for, or with the JAX package loaded, it prints no
result and exits with a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lmrs_tpu")
COUNTERS = ("tokens_emitted", "decode_seconds", "decode_steps",
            "prefix_hits", "prefix_tokens_saved", "pages_peak")


def forbidden_modules():
    """Top-level names of loaded modules that the port must not load,
    compared whole (`lmrs_tpu_torch` is not `lmrs_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def counters(sched, rec=None, names=()) -> dict:
    """The port's counters (`COUNTERS` and `names`, those an architecture's
    costs need), and in a traced run the prompt tokens admitted so far
    (`record.Recorder`)."""
    out = {k: float(getattr(sched, k, 0)) for k in COUNTERS + tuple(names)}
    out["admitted_prompt_tokens"] = float(rec.admitted_tokens
                                          if rec is not None else 0)
    return out


def warm_up(thread, cfg, mix: dict, conf: dict, seed: int) -> None:
    """Every prefill padding the traffic can take (8 to the chunk, and a
    whole chunk), sampled and greedy decode chunks at the full batch, and
    a prefix fork with its boundary-page copy; then the pool is empty."""
    import threading

    import numpy as np

    rng = np.random.default_rng([seed % (1 << 63), 99])
    s = conf["serve"]
    chunk = min(s["prefill_chunk"], s["page_size"])
    lens, n = [], 5
    while n < chunk:
        lens.append(n)
        n = 2 * n + 2
    lens.append(chunk + 1)
    done = threading.Event()
    left = [len(lens) + 2]

    def fin(_out):
        left[0] -= 1
        if left[0] == 0:
            done.set()

    base = rng.integers(0, cfg.vocab_size, chunk + 40).tolist()

    sent = []

    def fork(_tok):
        if not sent:
            sent.append(1)
            thread.sched.submit(base + [1, 2, 3], max_new_tokens=3,
                                on_done=fin, temperature=0.0)

    def start():
        for i, k in enumerate(lens):
            thread.sched.submit(rng.integers(0, cfg.vocab_size, k).tolist(),
                                max_new_tokens=2 * s["decode_chunk"] + 1,
                                on_done=fin,
                                temperature=0.0 if i % 2 else None)
        thread.sched.submit(base, max_new_tokens=3 * s["decode_chunk"],
                            on_token=fork, on_done=fin, temperature=0.0)

    thread.call(start)
    if not done.wait(600):
        raise RuntimeError("warm-up requests did not finish")


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = None, fault=None, keep: bool = False) -> dict:
    """One run of `cell`; returns the result dict.  `fault`, if given,
    is called with the scheduler before the load starts (tests plant
    faults through it); `keep` adds the weights and the checked sample
    under "_sample" (the control study reads them)."""
    import torch

    from lmrs_tpu_torch.serve.scheduler import SchedulerThread
    from portbench import arch as A
    from portbench import check as C
    from portbench import images, serving, spec
    from portbench.drive import Load
    from portbench.readings import Context
    from portbench.record import Recorder
    from portbench.trace import Profiler, breakdown
    from portbench.traffic import make_script

    t_start = time.perf_counter() if t_start is None else t_start
    torch.set_num_threads(1)
    conf, mix = cell.config, cell.traffic
    dev = torch.device(device)
    cfg, weights, params = serving.build_text(conf, seed, dev)
    vision = serving.port_vision(conf, weights)
    arch_counters = A.counters(A.load(conf["model_type"]))
    sched = serving.build_scheduler(cfg, params, conf, mix["batch"], seed,
                                    dev)
    sched.warmup()                       # builds or loads the kernels
    if fault is not None:
        fault(sched)
    thread = SchedulerThread(sched)
    warm_up(thread, cfg, mix, conf, seed)
    script = make_script(mix, seed, cfg.vocab_size, conf["max_context"],
                         conf["serve"]["decode_chunk"])
    rec = prof = None
    spans = []
    image_job = None
    armed = []          # a traced image cell: start the stretch at a job

    def begin():
        if rec.on:
            return
        if dev.type == "cuda":
            prof.start()
        rec.on = True

    def before_image():
        if armed and not rec.on:
            begin()

    if vision is not None:
        image_job = images.job_maker(
            sched, cfg, params, vision, conf, dev, spans,
            images.pixels_for(script, mix, seconds), lambda: rec,
            before=before_image)
    load = Load(thread, script,
                lease=bool(mix.get("session", {}).get("lease")),
                image_job=image_job,
                ramp_seconds=float(mix.get("ramp_seconds", 0.0)))
    if trace:
        rec = Recorder(sched)
        thread.call(rec.install)
        prof = Profiler()
        if dev.type == "cuda":
            thread.call(prof.prime)
    thread.call(load.start)
    if not load.wait_started(300):
        raise RuntimeError("the ramp did not reach every client in 300 s")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    c0 = counters(sched, rec, arch_counters)
    stretch = min(float(mix.get("trace_seconds", 4.0)), seconds)
    if trace:
        # the traced stretch: whole ticks from (close - stretch), at least
        # `stretch` seconds once the profiler runs; with images, from the
        # first image job after (close - stretch), so that the stretch
        # holds one (the profiler starts before it, between ticks)
        time.sleep(max(0.0, w0 + seconds - stretch - time.perf_counter()))
        if vision is not None:
            armed.append(True)
            limit = time.perf_counter() + stretch + 30.0
            while not rec.on and time.perf_counter() < limit:
                time.sleep(0.01)
        thread.call(begin)
    time.sleep(max(0.0, w0 + seconds - time.perf_counter()))
    w1 = time.perf_counter()
    c1 = counters(sched, rec, arch_counters)
    load.stopping = True
    load.stop_at = w1
    if trace:
        time.sleep(max(0.0, prof.t0 + stretch - time.perf_counter()))

        def end():
            rec.on = False
            if dev.type == "cuda":
                prof.stop()

        thread.call(end)
    deadline = time.perf_counter() + 60.0
    while not load.settled(w0, w1) and time.perf_counter() < deadline:
        time.sleep(0.05)
    thread.shutdown()
    thread._thread.join(120)
    if thread._thread.is_alive():
        raise RuntimeError("the scheduler thread did not stop")
    if thread.error is not None:
        raise RuntimeError("the scheduler failed") from thread.error
    if load.error is not None:
        raise RuntimeError("the session starter failed") from load.error
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    tr = prof.read() if (prof is not None and prof.path) else None
    ctx = Context(cfg=cfg, conf=conf, mix=mix, card=kind, w0=w0, w1=w1,
                  setup_s=setup_s, recs=list(load.recs), c0=c0, c1=c1,
                  trace=tr, recorder=rec, spans=list(spans))
    metrics = spec.read_metrics(cell.per_layer if trace
                                else cell.end_to_end, ctx)
    due = ctx.due()
    failed = sum(1 for r in due if r.error is not None or r.first is None)
    errors = collections.Counter(r.error for r in due if r.error)
    info = dict(window_s=ctx.window_s, turns_due=len(due), errors=dict(errors),
                turns_done=sum(1 for r in load.recs
                               if r.done is not None and w0 <= r.done < w1),
                pages_peak=sched.pages_peak, n_pages=sched.n_pages - 1,
                counters={k: c1[k] - c0[k] for k in c0})
    late = sorted(x for d, x in load.late if w0 <= d < w1)
    if script.arrivals is not None:
        info["backlog"] = [load.backlog(w0), load.backlog(w1)]
        info["sessions_due"] = sum(1 for a in script.arrivals
                                   if w0 <= load.t0 + a < w1)
        info["sessions_done"] = sum(
            1 for c, turns in enumerate(script.clients)
            for r in load.recs if r.spec.client == c
            and r.spec.index == len(turns) - 1 and r.done is not None
            and w0 <= r.done < w1)
    if late:
        # how late the open-loop generator started the sessions due in
        # the window (its own thread's delay, before any server wait)
        info["generator_late_ms"] = dict(
            median=1e3 * late[len(late) // 2], max=1e3 * late[-1],
            sessions=len(late))
    # free the server's state before the reference runs: the process's
    # peak is read above and never falls again; a turn's request holds the
    # load's callbacks, and through them the server and its weights
    for r in load.recs:
        r.req = None
    sched.cache = None
    del sched, thread, load, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    lim = conf.get("check", {})
    picked = C.sample(ctx.recs, w0, w1, seed, lim.get("sample_tokens", 600),
                      lim.get("sample_turns", 6))
    t_ref = time.perf_counter()
    served = C.gaps(conf, weights, picked, dev) if picked else []
    info["reference_s"] = time.perf_counter() - t_ref
    info["sample_turns"] = len(picked)
    checks = C.verdict(conf, served)
    result = {
        "correct": all(c["ok"] for c in checks.values()),
        "attempted": len(due), "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": int(peak)},
    }
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = breakdown(tr)
    result["check"] = {k: {"value": v["value"], "limit": v["limit"]}
                       for k, v in checks.items()}
    result["_info"] = info
    result["_checks"] = checks
    if keep:
        result["_sample"] = (weights, picked, served)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    from portbench.spec import load_cell

    cell = load_cell(args.workload, root)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   t_start=T_START)
    # everything the run loaded, the output check and the readers included
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    info, checks = res.pop("_info"), res.pop("_checks")
    print(json.dumps({"run": args.workload, "seed": args.seed,
                      "trace": args.trace, **info}))
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} {c['rule']} {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
