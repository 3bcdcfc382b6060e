"""The port's continuous-batching scheduler on a mesh of ranks
(`BatchScheduler(..., mesh=)`, `parallel.tp.make_mesh_scheduler`; CPU, two
gloo rank processes a mesh) against the one-device scheduler on the same
file and against the JAX BatchScheduler on one device: tp = 2 over the
paged pool (kernel J on the local kv heads) and over the per-slot cache
(I), with bf16, int8 and int4 caches, speculation, the admission prefix
cache (forks are mesh calls) and image-style embedding rows; cp = 2 over
the per-slot cache (B1 merged over the shards), bf16 and int8, with
speculation.  A page pool with cp is refused.

Tolerances: tp against the one-device scheduler, token for token (the
same quantized groups; only the f32 order of two partial sums differs,
and these prompts' greedy runs hold no near-tie at 1e-3 of the logit
scale); cp the same; against JAX token for token up to the first step
whose top-2 margin in a one-device run is below 1e-2 of the logit scale
(tests/test_torch_scheduler.py).
"""

import pytest
import torch

from lmrs_tpu_torch.config import ModelType, QuantType
from lmrs_tpu_torch.parallel.distributed import Mesh
from lmrs_tpu_torch.parallel.tp import make_mesh_scheduler
from lmrs_tpu_torch.runtime.engine import Engine
from lmrs_tpu_torch.serve.scheduler import BatchScheduler
from test_torch_scheduler import PROMPTS, build, run
from torch_mesh_cases import open_model

torch.set_num_threads(1)

N_NEW = 10
# head_dim 128: the paged pool's geometry; tp = 2 leaves 1 kv head a rank
KW = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=2, n_kv_heads=2,
          head_dim=128, vocab_size=256, seq_len=256)
BASE = dict(max_batch=4, max_ctx=128, cache_dtype=torch.float32,
            prefill_chunk=8, decode_chunk=4, temperature=0.0)
PAGED = dict(page_size=64, pool_tokens=4 * 128)
SHARED = [3, 1, 4, 1, 5, 9, 2, 6] * 5          # 40 tokens: forked prefix


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_sched")
    cfg, params = build(d, ModelType.GEMMA, QuantType.Q8_0, seed=3, **KW)
    f = open_model(str(d / "m3_GEMMA.lmrs"))
    meshes = {"tp": Mesh.start(f, tp=2, device="cpu", timeout=120),
              "cp": Mesh.start(f, cp=2, device="cpu", timeout=120)}
    yield dict(cfg=cfg, params=params, f=f, **meshes)
    for m in meshes.values():
        m.shutdown()


def on_mesh(model, axis, **kw):
    base = dict(BASE)
    base.update(kw)
    return make_mesh_scheduler(model["f"], mesh=model[axis], **base)


def one_device(model, **kw):
    base = dict(BASE)
    base.update(kw)
    return BatchScheduler(model["cfg"], model["params"], device="cpu",
                          **base)


def both(model, axis, prompts=PROMPTS, **kw):
    """(mesh scheduler's streams, one-device scheduler's streams)."""
    s = on_mesh(model, axis, **kw)
    try:
        got = run(s, prompts, N_NEW)
    finally:
        s.close()
    return got, run(one_device(model, **kw), prompts, N_NEW)


@pytest.mark.parametrize("kw", [dict(PAGED),
                                dict(PAGED, cache_dtype=torch.bfloat16),
                                dict(PAGED, cache_dtype=torch.int8),
                                dict(PAGED, cache_dtype="int4"),
                                dict(),
                                dict(cache_dtype=torch.int8)],
                         ids=["paged-f32", "paged-bf16", "paged-int8",
                              "paged-int4", "contiguous-f32",
                              "contiguous-int8"])
def test_tp_scheduler_matches_one_device(model, kw):
    got, want = both(model, "tp", **kw)
    assert got == want and len(set(sum(want, []))) >= 3


@pytest.mark.parametrize("kw", [dict(PAGED), dict()],
                         ids=["paged", "contiguous"])
def test_tp_scheduler_speculation_and_prefix_forks(model, kw):
    """Speculative greedy decoding (k = 3, verify windows through the
    sharded step) gives the plain streams; a prompt sharing a resident
    slot's 40-token prefix forks its rows (a mesh call: a page copy or a
    row copy on every rank) and reads the one-device streams."""
    prompts = [SHARED + [7, 7], SHARED + [8], SHARED[:20] * 2 + SHARED[:3]]
    got, want = both(model, "tp", prompts, **kw)
    assert got == want
    s = on_mesh(model, "tp", speculative_k=3, **kw)
    try:
        assert run(s, prompts, N_NEW) == want
        assert s.spec_proposed > 0
    finally:
        s.close()
    s = on_mesh(model, "tp", max_batch=2, **kw)
    try:
        done = {}
        s.submit(prompts[0], max_new_tokens=N_NEW,
                 lease=s.new_conversation(),
                 on_done=lambda o: done.setdefault(0, o))
        s.run()
        s.submit(prompts[1], max_new_tokens=N_NEW,
                 on_done=lambda o: done.setdefault(1, o))
        s.run()
        assert s.prefix_hits == 1 and done == {0: want[0], 1: want[1]}
    finally:
        s.close()


def test_tp_scheduler_prefill_embeds(model):
    """An image's rows (here the prompt's own embedding rows, gathered on
    the ranks) prefilled into a leased slot, then a turn: the one-device
    scheduler's stream."""
    rows = model["tp"].embed(torch.tensor(PROMPTS[2]))
    outs = []
    for s in (on_mesh(model, "tp", **PAGED), one_device(model, **PAGED)):
        lease = s.new_conversation()
        s.prefill_embeds(lease, rows)
        done = {}
        s.submit([11, 12], max_new_tokens=N_NEW, lease=lease,
                 on_done=lambda o: done.setdefault(0, o))
        s.run()
        outs.append(done[0])
        s.close()
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kw", [dict(), dict(cache_dtype=torch.int8),
                                dict(speculative_k=3)],
                         ids=["f32", "int8", "speculative"])
def test_cp_scheduler_matches_one_device(model, kw):
    """cp = 2 over the per-slot cache: each rank holds half of every
    slot's rows; writes are row-exact and attention is the merged cp
    partials."""
    prompts = PROMPTS + [SHARED * 2]           # 80 rows: past 68 = S/cp
    got, want = both(model, "cp", prompts, **kw)
    assert got == want


def test_cp_refuses_a_page_pool(model):
    with pytest.raises(ValueError, match="--pool-tokens with --cp"):
        on_mesh(model, "cp", **PAGED)


def test_tp_scheduler_matches_the_jax_scheduler(model):
    """One wave on the tp = 2 mesh's per-slot f32 cache against the JAX
    BatchScheduler on one device, greedy, token for token up to the first
    near-tie (module note)."""
    import jax.numpy as jnp

    import lmrs_tpu.io.lmrs as jl
    from lmrs_tpu.io.params import params_from_lmrs as jax_params
    from lmrs_tpu.serve.scheduler import BatchScheduler as JaxScheduler

    jf = jl.read_lmrs(model["f"].path)
    js = JaxScheduler(jf.cfg, jax_params(jf), max_batch=4, max_ctx=128,
                      cache_dtype=jnp.float32, prefill_chunk=8,
                      decode_chunk=4, min_attn_bucket=32, temperature=0.0)
    want = run(js, PROMPTS, N_NEW)
    s = on_mesh(model, "tp")
    try:
        got = run(s, PROMPTS, N_NEW)
    finally:
        s.close()
    n_cmp = 0
    for p, g, w in zip(PROMPTS, got, want):
        eng = Engine(model["cfg"], model["params"], device="cpu",
                     cache_dtype=torch.float32)
        logits, n_eq = eng.prefill(p), N_NEW
        for step in range(N_NEW):
            top = torch.topk(logits, 2).values
            if float(top[0] - top[1]) < 1e-2 * float(logits.abs().max()):
                n_eq = step
                break
            logits = eng.decode_step(int(logits.argmax()))
        assert g[:n_eq] == w[:n_eq], (g, w, n_eq)
        n_cmp += n_eq
    assert n_cmp >= 5
