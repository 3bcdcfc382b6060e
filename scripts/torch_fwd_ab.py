"""Host launch time of `forward_batched`, the parent's against this
tree's, in one process on the same cache and weights: B lanes at ~1,024
tokens of context (Phi-3.5-mini, Q4_0, paged bf16 pool); blocks of 8
forwards launched back to back, the two versions alternating block by
block (order swapped each round), each block timed to its launch's end
and to the device's end.

    cd <this tree> && python3 scripts/torch_fwd_ab.py <lanes> <rounds> <parent tree>

(on the card; the parent tree is a checkout of the other version).
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

import lmrs_tpu_torch.models.transformer as ctf  # noqa: E402
from portbench import serving  # noqa: E402

spec = importlib.util.spec_from_file_location(
    "parent_transformer", sys.argv[3] + "/lmrs_tpu_torch/models/transformer.py")
ptf = importlib.util.module_from_spec(spec)
sys.modules["parent_transformer"] = ptf
spec.loader.exec_module(ptf)
B, ROUNDS = int(sys.argv[1]), int(sys.argv[2])
conf = json.load(open("portbench/configs/phi35-mini-q4.json"))
dev = torch.device("cuda")
cfg, _, params = serving.build_text(conf, 7, dev)
s = serving.build_scheduler(cfg, params, conf, B, 7, dev)
s.warmup()
rng = np.random.default_rng(1)
for i in range(B):
    s.submit(rng.integers(0, cfg.vocab_size, 1024).tolist(),
             max_new_tokens=2000)
while s.active < B:
    s.step()
s.step()
toks = torch.zeros(B, dtype=torch.long, device=dev)
p = torch.tensor([sl.pos for sl in s.slots], dtype=torch.int32, device=dev)
res = {"parent": [], "change": []}


def block(mod):
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(8):
        mod.forward_batched(params, cfg, s.cache, toks, p, table=s._table_dev,
                            w8a8=s.w8a8)
    launch = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e3 * launch / 8, 1e3 * (time.perf_counter() - t) / 8


with torch.no_grad():
    block(ctf), block(ptf)
    for r in range(ROUNDS):
        order = [("parent", ptf), ("change", ctf)]
        for name, mod in (order if r % 2 else order[::-1]):
            res[name].append(block(mod))
pairs = [c[0] / q[0] for c, q in zip(res["change"], res["parent"])]
print("FWD_AB", json.dumps(dict(
    B=B, rounds=ROUNDS,
    parent_launch_ms=statistics.median(v[0] for v in res["parent"]),
    change_launch_ms=statistics.median(v[0] for v in res["change"]),
    parent_total_ms=statistics.median(v[1] for v in res["parent"]),
    change_total_ms=statistics.median(v[1] for v in res["change"]),
    ratio_median=statistics.median(pairs),
    ratio_quartiles=statistics.quantiles(pairs, n=4),
    change_faster_blocks=sum(1 for x in pairs if x < 1))))
