"""The scheduler's tick, the parent's `BatchScheduler` against this
tree's, in one process on the same weights: two schedulers of B lanes
(pools of B x 2,048 rows each), the same prompts (1,024 tokens) and seed,
stepped in turns (order swapped each round); each tick timed on the host
clock, and its decode chunk by the scheduler's own `decode_seconds`.

    cd <this tree> && python3 scripts/torch_sched_ab.py <lanes> <rounds> <parent tree>

(on the card; two pools of lanes x 2,048 rows must fit it).
"""
import importlib.util
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
import torch  # noqa: E402

from lmrs_tpu_torch.serve.scheduler import BatchScheduler  # noqa: E402
from portbench import serving  # noqa: E402

spec = importlib.util.spec_from_file_location(
    "parent_scheduler", sys.argv[3] + "/lmrs_tpu_torch/serve/scheduler.py")
psm = importlib.util.module_from_spec(spec)
sys.modules["parent_scheduler"] = psm
spec.loader.exec_module(psm)
B, ROUNDS = int(sys.argv[1]), int(sys.argv[2])
conf = json.load(open("portbench/configs/phi35-mini-q4.json"))
dev = torch.device("cuda")
cfg, _, params = serving.build_text(conf, 7, dev)
sv = conf["serve"]


def make(cls):
    s = cls(cfg, params, max_batch=B, max_ctx=conf["max_context"],
            cache_dtype=sv["cache_dtype"], temperature=sv["temperature"],
            top_p=sv["top_p"], seed=7, pool_tokens=B * 2048,
            page_size=sv["page_size"], prefill_chunk=256, decode_chunk=8,
            w8a8=sv["w8a8"], device=dev)
    rng = np.random.default_rng(1)
    for i in range(B):
        s.submit(rng.integers(0, cfg.vocab_size, 1024).tolist(),
                 max_new_tokens=900)
    while s.active < B:
        s.step()
    s.step()
    return s


sched = {"parent": make(psm.BatchScheduler), "change": make(BatchScheduler)}
sched["change"].warmup()
res = {k: [] for k in sched}
for r in range(ROUNDS):
    names = ["parent", "change"] if r % 2 else ["change", "parent"]
    for k in names:
        s = sched[k]
        torch.cuda.synchronize()
        d0, n0 = s.decode_seconds, s.decode_steps
        t = time.perf_counter()
        s.step()
        tick = time.perf_counter() - t
        res[k].append((1e3 * tick, 1e3 * (s.decode_seconds - d0)
                       / max(1, s.decode_steps - n0)))
ratio = [c[1] / p[1] for c, p in zip(res["change"], res["parent"])]
print("SCHED_AB", json.dumps(dict(
    B=B, rounds=ROUNDS,
    parent_step_ms=statistics.median(v[1] for v in res["parent"]),
    change_step_ms=statistics.median(v[1] for v in res["change"]),
    parent_tick_ms=statistics.median(v[0] for v in res["parent"]),
    change_tick_ms=statistics.median(v[0] for v in res["change"]),
    step_ratio_median=statistics.median(ratio),
    step_ratio_quartiles=statistics.quantiles(ratio, n=4),
    change_faster_ticks=sum(1 for x in ratio if x < 1),
    outputs_equal=[sl.req.out if sl.req else None
                   for sl in sched["parent"].slots]
    == [sl.req.out if sl.req else None for sl in sched["change"].slots])))
