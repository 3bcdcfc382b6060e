"""The port's scheduler over the paged KV pool (`BatchScheduler(...,
pool_tokens=...)`, CPU: kernel J's plain version): a shared pool of pages
behind per-slot page tables, page 0 the trash page.  As
tests/test_paged.py holds the JAX scheduler: the pool gives the contiguous
cache's tokens, admits under backpressure, shares prefix pages, frees
pages behind the sliding window, never spends a page on prefill padding,
and serves the int4 cache in both packings.

Tolerance: token for token throughout (the paged and the contiguous cache
hold the same values and kernel J's plain version reads them in the same
order as kernel I's; the int4 pool against an Engine on an int4 cache:
the same quantized rows).
"""

import numpy as np
import pytest
import torch

from lmrs_tpu_torch.config import ModelType, QuantType
from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig
from test_torch_scheduler import PROMPTS, build, run, sched

torch.set_num_threads(1)

N_NEW = 10
KW = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=2, n_kv_heads=2,
          head_dim=128, vocab_size=256, seq_len=256)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return build(tmp_path_factory.mktemp("paged"), ModelType.GEMMA,
                 QuantType.Q8_0, seed=3, **KW)


def paged(cfg, params, **kw):
    base = dict(max_ctx=128, page_size=64, pool_tokens=4 * 128)
    base.update(kw)
    return sched(cfg, params, **base)


def pages_held(s):
    return sum(1 for sl in s.slots for p in sl.pages if p)


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16,
                                         torch.int8])
def test_paged_matches_contiguous(model, cache_dtype):
    cfg, params = model
    want = run(sched(cfg, params, max_ctx=128, cache_dtype=cache_dtype))
    s = paged(cfg, params, cache_dtype=cache_dtype)
    assert run(s) == want
    # every page went back to the pool, the table is clear
    assert len(s._free_pages) == s.n_pages - 1 and not s._table.any()
    assert s.pages_peak >= 3


def test_paged_staggered_admission(model):
    cfg, params = model
    want = run(sched(cfg, params, max_ctx=128))
    s = paged(cfg, params, max_batch=2)
    done = {}
    s.submit(PROMPTS[0], max_new_tokens=N_NEW,
             on_done=lambda o: done.setdefault(0, o))
    s.step()
    s.step()
    for i in (1, 2):
        s.submit(PROMPTS[i], max_new_tokens=N_NEW,
                 on_done=lambda o, i=i: done.setdefault(i, o))
    s.run()
    assert [done[i] for i in range(3)] == want


def test_paged_pool_smaller_than_dense(model):
    """A pool of 256 rows serves four slots whose contiguous cache would
    need 4 x (128 + slack) rows."""
    cfg, params = model
    want = run(sched(cfg, params, max_ctx=128))
    s = paged(cfg, params, pool_tokens=256)
    assert s.cache.k.shape[1] == 256 // 64 + 1
    assert run(s) == want


def test_paged_backpressure(model):
    """With room for two requests' pages, the others wait and run once
    pages free; none fails."""
    cfg, params = model
    s = paged(cfg, params, page_size=64, pool_tokens=128, max_batch=4)
    reqs = [s.submit(p, max_new_tokens=6) for p in
            ([1, 2, 3], [4, 5], [6, 7, 8, 9], [10, 11])]
    s.run()
    assert all(r.error is None and len(r.out) == 6 for r in reqs)
    assert s.pages_peak <= 2


def test_paged_lease_multiturn(model):
    cfg, params = model
    eng = Engine(cfg, params, device="cpu", cache_dtype=torch.float32)
    g = GenerationConfig(temperature=0.0, max_new_tokens=4)
    turn1, turn2 = eng.generate(PROMPTS[0], g), eng.generate(PROMPTS[1], g)
    s = paged(cfg, params, max_batch=2)
    lease = s.new_conversation()
    done = {}
    for name, p in (("t1", PROMPTS[0]), ("t2", PROMPTS[1])):
        s.submit(p, max_new_tokens=4, lease=lease,
                 on_done=lambda o, name=name: done.setdefault(name, o))
        s.run()
    assert done == {"t1": turn1, "t2": turn2}
    assert s.slots[lease.slot_idx].pages          # resident between turns
    s.end_conversation(lease)
    assert len(s._free_pages) == s.n_pages - 1


def test_paged_oversized_prompt_errors(model):
    """A prompt larger than the whole pool fails with a message instead of
    waiting forever."""
    cfg, params = model
    s = paged(cfg, params, page_size=64, pool_tokens=128, max_ctx=256)
    done = {}
    req = s.submit(list(range(1, 200)), max_new_tokens=4,
                   on_done=lambda o: done.setdefault("x", o))
    s.run()
    assert "whole pool" in req.error and done["x"] == []


def test_paged_speculative(model):
    cfg, params = model
    prompts = [[5, 9, 5, 9, 5, 9, 5], [1, 5, 9], [7, 3, 11, 13]]
    want = run(paged(cfg, params), prompts)
    s = paged(cfg, params, speculative_k=3)
    assert run(s, prompts) == want
    assert s.spec_proposed > 0


def test_paged_speculative_sampled_slots(model):
    cfg, params = model
    s = paged(cfg, params, speculative_k=3, seed=2)
    reqs = [s.submit(p, max_new_tokens=N_NEW, temperature=0.8, top_p=0.9)
            for p in PROMPTS]
    s.run()
    assert all(len(r.out) == N_NEW and r.error is None for r in reqs)


@pytest.mark.parametrize("n_shared", [70, 64])
def test_paged_prefix_fork(model, n_shared):
    """A follower shares the donor's full prefix pages (refcounted) and
    copies the partial boundary page (none at 64 rows): tokens equal to a
    run without the prefix cache."""
    cfg, params = model
    shared = list(np.random.default_rng(1).integers(1, 200, n_shared))

    def go(prefix_min):
        s = paged(cfg, params, pool_tokens=8 * 64, prefix_cache_min=16)
        s.prefix_cache_min = prefix_min
        lease = s.new_conversation()
        done = {}
        s.submit(shared + [3], max_new_tokens=4, lease=lease,
                 on_done=lambda o: done.setdefault("a", o))
        s.run()
        donor_pages = list(s.slots[lease.slot_idx].pages)
        b = s.submit(shared + [9, 8], max_new_tokens=4,
                     on_done=lambda o: done.setdefault("b", o))
        s._admit()                    # admission forks here
        shared_now = int(s._page_refs[donor_pages[0]])
        s.run()
        return done, s, donor_pages, shared_now, b

    plain, *_ = go(0)
    forked, s, donor_pages, shared_now, b = go(16)
    assert s.prefix_hits == 1 and s.prefix_tokens_saved == n_shared
    assert shared_now == 2            # the donor's first page is shared
    assert s._page_refs[donor_pages[0]] == 1     # released by the follower
    assert forked == plain and b.error is None


def test_paged_pad_overhang_costs_no_page(model):
    """Prefill pads a chunk to a power of two, but the pad rows land in the
    trash page: a turn whose real rows fit the slot's page needs no
    second one."""
    cfg, params = model
    s = paged(cfg, params, page_size=64, pool_tokens=128, max_batch=2)
    la, lb = s.new_conversation(), s.new_conversation()
    done = {}
    s.submit(list(np.arange(1, 53) % 200), max_new_tokens=5, lease=la,
             on_done=lambda o: done.setdefault("a", o))
    s.submit([1, 2, 3], max_new_tokens=4, lease=lb,
             on_done=lambda o: done.setdefault("b", o))
    s.run()
    assert len(done["a"]) == 5 and not s._free_pages
    # lease A at pos 56 of its one page; a 4-token turn is padded to 8
    # rows (past row 64), its real rows end at 60
    s.submit([9, 8, 7, 6], max_new_tokens=1, lease=la,
             on_done=lambda o: done.setdefault("a2", o))
    s.run()
    assert len(done["a2"]) == 1


def test_paged_admission_reserves_staged_prefills(model):
    """Two prompts that each need the whole pool: the second waits for
    the first instead of both being staged and one dying mid-prefill."""
    cfg, params = model
    s = paged(cfg, params, page_size=64, pool_tokens=128, max_batch=2)
    reqs = [s.submit(list(np.arange(2 + i, 102 + i) % 200),
                     max_new_tokens=4) for i in range(2)]
    s.run()
    assert all(r.error is None and len(r.out) == 4 for r in reqs)


@pytest.mark.parametrize("kh,hd", [(1, 256), (2, 128)],
                         ids=["half", "pair"])
def test_paged_int4_pool_matches_engine(tmp_path, kh, hd):
    """The int4 pool in both packings gives an int4-cache Engine's
    tokens."""
    cfg, params = build(tmp_path, ModelType.GEMMA, QuantType.Q8_0, seed=5,
                        **dict(KW, n_heads=2, n_kv_heads=kh, head_dim=hd))
    want = [Engine(cfg, params, device="cpu", cache_dtype="int4").generate(
        p, GenerationConfig(temperature=0.0, max_new_tokens=N_NEW))
        for p in PROMPTS]
    s = paged(cfg, params, cache_dtype="int4", max_batch=2,
              pool_tokens=256)
    assert s.cache.k.shape[-1] == kh * hd // 2
    assert run(s) == want


def test_paged_window_page_recycling(tmp_path):
    """A windowed slot decoding past several windows keeps O(window)
    pages: pages wholly behind the window return to the pool mid-stream,
    so a pool smaller than the context serves it, with the contiguous
    cache's tokens."""
    cfg, params = build(tmp_path, ModelType.GEMMA, QuantType.Q8_0, seed=3,
                        **dict(KW, sliding_window=32))
    n_new = 150
    want = run(sched(cfg, params, max_ctx=256), [PROMPTS[0]], n_new)[0]
    s = paged(cfg, params, max_ctx=256, page_size=16, pool_tokens=96)
    done = {}
    req = s.submit(PROMPTS[0], max_new_tokens=n_new,
                   on_done=lambda o: done.setdefault("x", o))
    max_held = 0
    while s.has_work():
        s.step()
        max_held = max(max_held, pages_held(s))
    assert req.error is None, req.error
    assert done["x"] == want
    assert max_held <= s._max_live_pages(256)
    assert len(s._free_pages) == s.n_pages - 1 and not s._table.any()


def test_window_freed_slot_is_no_prefix_donor(tmp_path):
    cfg, params = build(tmp_path, ModelType.GEMMA, QuantType.Q8_0, seed=3,
                        **dict(KW, sliding_window=32))
    prompt = list(np.arange(1, 41) % 200)
    alone = run(paged(cfg, params, max_ctx=256, page_size=16,
                      pool_tokens=240, prefix_cache_min=8), [prompt], 60)[0]
    s = paged(cfg, params, max_ctx=256, page_size=16, pool_tokens=240,
              prefix_cache_min=8, max_batch=2)
    lease = s.new_conversation()
    run(s, [prompt], 60, lease=lease)
    assert s.slots[lease.slot_idx].win_freed > 0
    assert run(s, [prompt], 60)[0] == alone
    assert s.prefix_hits == 0
