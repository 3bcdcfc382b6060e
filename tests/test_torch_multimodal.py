"""The port's multimodal path (Phi-3.5-vision) against the JAX package's on
the CPU, on one tiny multimodal `.lmrs` file: an image to its embedding
rows, the rows prefilled into the Engine's cache before a text turn, the
same through a scheduler lease, and the rules around the image rows.

Tolerances:
- encode_image_to_embeds: as processor_forward in
  tests/test_torch_vision.py (1e-5 of the output scale on at least 99% of
  the rows, 1e-3 on every value: a rounding step of the Q8 activation
  quantizer can go the other way where the two packages' f32 sums differ
  in the last bit, and moves the row it feeds); float weights 1e-6;
- greedy tokens after the image: the JAX Engine's (matmul_impl="fast") up
  to the first step whose top-2 logit margin in the JAX model is below
  1e-2 of the logit scale, as in tests/test_torch_engine.py;
- the scheduler against the port's Engine on the same rows: token for
  token (the same plain versions at the same row counts but for the
  padding of a chunk), and up to the near-tie rule above where a padded
  chunk's rows differ in the last bits.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lmrs_tpu.io.lmrs as jl
from lmrs_tpu.io.params import params_from_lmrs as jax_params_from_lmrs
from lmrs_tpu.models.phi3v import \
    encode_image_to_embeds as jax_encode_image_to_embeds
from lmrs_tpu.models.transformer import embed_tokens as jax_embed
from lmrs_tpu.models.transformer import forward as jax_forward
from lmrs_tpu.models.transformer import init_kv_cache as jax_init_kv_cache
from lmrs_tpu.runtime.engine import Engine as JaxEngine
from lmrs_tpu.runtime.engine import GenerationConfig as JaxGenerationConfig

import lmrs_tpu_torch.io.lmrs as tl
from lmrs_tpu_torch.config import ModelType, QuantType
from lmrs_tpu_torch.io.params import params_from_lmrs, vision_params_from_lmrs
from lmrs_tpu_torch.io.synthetic import (random_multimodal_weights,
                                         random_weights, tiny_config,
                                         tiny_processor_config,
                                         tiny_vision_config)
from lmrs_tpu_torch.models.phi3v import encode_image_to_embeds
from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig
from lmrs_tpu_torch.serve.scheduler import BatchScheduler
from test_torch_vision import assert_close_up_to_rounding_steps

torch.set_num_threads(1)

# a config of its own (seq_len): the JAX package keeps traced programs by
# config
SEQ_LEN = 448
TURN = [450, 311, 7321, 29973, 32007, 29871, 13, 32001, 29871, 13]
N_NEW = 12


def write_tiny_mm(path, quant=QuantType.Q8_0, seed=4):
    """A tiny Phi-3.5-vision file: Phi's 32,064-token vocabulary (the image
    wrapping's ids reach 32,010), head_dim 48 padded to a 128-lane cache
    (so the paged pool serves it), the tiny CLIP encoder and projector.
    The text weights have std 0.1: at 0.02 the tiny model's logits are so
    flat that its greedy stream is a run of near-ties (as
    tests/test_torch_engine.py takes 0.1 for tiny-llama)."""
    cfg = tiny_config(ModelType.PHI, quant, multimodal=True, seq_len=SEQ_LEN,
                      vocab_size=32064, head_dim=48,
                      rope_short_factor=tuple(1.0 + 0.05 * i
                                              for i in range(24)))
    vc = tiny_vision_config(quant)
    pc = tiny_processor_config(quant, cfg.dim)
    weights = random_multimodal_weights(cfg, vc, pc, seed)
    weights.update(random_weights(cfg, seed, scale=0.1))
    tl.write_lmrs(path, cfg, weights, vision_cfg=vc, processor_cfg=pc)
    return path


def image(seed=0, shape=(64, 96, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def mm(tmp_path_factory):
    """(path, PNG path, port cfg, port params, vision params) of one tiny
    Q8_0 multimodal file."""
    from PIL import Image

    d = tmp_path_factory.mktemp("mm")
    path = write_tiny_mm(str(d / "mm.lmrs"))
    png = str(d / "img.png")
    Image.fromarray(image()).save(png)
    f = tl.read_lmrs(path)
    params = params_from_lmrs(f, device="cpu")
    return path, png, f.cfg, params, vision_params_from_lmrs(f, "cpu")


@pytest.fixture(scope="module")
def jax_side(mm):
    """The JAX package on the same file: (cfg, params, image rows)."""
    path, png = mm[:2]
    jf = jl.read_lmrs(path)
    jcfg = jf.cfg.replace(matmul_impl="fast")
    jp = jax_params_from_lmrs(jf, fuse_qkv=True)
    embeds = np.asarray(jax_encode_image_to_embeds(jf, jp, jcfg, png, 1))
    return jcfg, jp, embeds


@pytest.mark.parametrize("quant", [QuantType.Q8_0, QuantType.NONE])
def test_encode_image_to_embeds_matches_jax(tmp_path, quant):
    from PIL import Image

    path = write_tiny_mm(str(tmp_path / "mm.lmrs"), quant)
    png = str(tmp_path / "img.png")
    Image.fromarray(image(1, (77, 120, 3))).save(png)
    jf = jl.read_lmrs(path)
    want = np.asarray(jax_encode_image_to_embeds(
        jf, jax_params_from_lmrs(jf), jf.cfg, png, 4))
    f = tl.read_lmrs(path)
    params = params_from_lmrs(f, device="cpu")
    vision = vision_params_from_lmrs(f, "cpu")
    got = encode_image_to_embeds(vision, params, f.cfg, png, 4).numpy()
    # 4 + (24 * 25 + 1 + 12 * 13) + 3 rows: 120x77 takes 2x2 crops
    assert got.shape == want.shape == (764, f.cfg.dim)
    assert_close_up_to_rounding_steps(got, want)
    if quant == QuantType.NONE:
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # the decoded file and the array give the same rows
    arr = encode_image_to_embeds(vision, params, f.cfg,
                                 image(1, (77, 120, 3)), 4)
    np.testing.assert_array_equal(arr.numpy(), got)


def _jax_margins(jcfg, jp, embeds, tokens):
    """Top-2 logit margin of every token row of one teacher-forced JAX
    forward over [embeds, tokens] (the row at embeds + i predicts token
    i + 1), and the logit scale."""
    fwd = jax.jit(partial(jax_forward, cfg=jcfg, attn_len=jcfg.seq_len,
                          logit_idx="all"))
    x = jnp.concatenate([jnp.asarray(embeds),
                         jax_embed(jp, jcfg, jnp.asarray(tokens, jnp.int32))])
    logits, _ = fwd(jp, cache=jax_init_kv_cache(jcfg, jnp.bfloat16), x=x,
                    pos=jnp.int32(0))
    logits = np.asarray(logits)[embeds.shape[0]:]
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0], np.abs(logits).max()


def _engine_tokens(cfg, params, embeds, turn=TURN, **kw):
    eng = Engine(cfg, params, device="cpu", **kw)
    eng.prefill_embeds(torch.from_numpy(embeds), want_logits=False)
    assert eng.pos == embeds.shape[0]
    assert (eng._hist[:embeds.shape[0]] == -1).all()
    return eng, eng.generate(turn, GenerationConfig(temperature=0.0,
                                                    max_new_tokens=N_NEW))


def test_prefill_embeds_then_greedy_matches_jax_engine(mm, jax_side):
    _, _, cfg, params, _ = mm
    jcfg, jp, embeds = jax_side
    jeng = JaxEngine(jcfg, jp, min_attn_bucket=64)
    jeng.prefill_embeds(jnp.asarray(embeds), want_logits=False)
    assert jeng.pos == embeds.shape[0]
    want = jeng.generate(TURN, JaxGenerationConfig(temperature=0.0,
                                                   max_new_tokens=N_NEW))
    eng, got = _engine_tokens(cfg, params, embeds)
    assert len(got) == len(want) == N_NEW
    margins, scale = _jax_margins(jcfg, jp, embeds, TURN + want[:-1])
    close = np.nonzero(margins[len(TURN) - 1:] < 1e-2 * scale + 1e-4)[0]
    assert not close.size or close[0] >= 4
    n_eq = int(close[0]) if close.size else N_NEW
    assert got[:n_eq] == want[:n_eq]
    # greedy is reproducible across reset() and a fresh ingest
    eng.reset()
    eng.prefill_embeds(torch.from_numpy(embeds), want_logits=False)
    assert eng.generate(TURN, GenerationConfig(temperature=0.0,
                                               max_new_tokens=N_NEW)) == got


def _sched(cfg, params, paged, **kw):
    kw.setdefault("prefix_cache_min", 0)
    return BatchScheduler(cfg, params, max_batch=2, prefill_chunk=64,
                          decode_chunk=4, device="cpu",
                          pool_tokens=1024 if paged else None, page_size=64,
                          **kw)


@pytest.mark.parametrize("paged", [True, False])
def test_scheduler_prefill_embeds_matches_engine(mm, jax_side, paged):
    """An image prefix through a lease, then the turn, while a text
    request decodes beside it: both streams are the Engine's."""
    _, _, cfg, params, _ = mm
    embeds = jax_side[2]
    eng, want = _engine_tokens(cfg, params, embeds, prefill_chunk=64)
    text = [1, 32010, 29871, 13, 3923, 29991, 32007, 29871, 13, 32001]
    ref_text = Engine(cfg, params, device="cpu", prefill_chunk=64).generate(
        text, GenerationConfig(temperature=0.0, max_new_tokens=N_NEW))

    s = _sched(cfg, params, paged)
    lease = s.new_conversation()
    side = s.submit(text, max_new_tokens=N_NEW, temperature=0.0)
    s.step()                                   # the text request runs
    s.prefill_embeds(lease, torch.from_numpy(embeds))
    slot = s.slots[lease.slot_idx]
    assert slot.pos == embeds.shape[0]
    assert slot.tokens == [-1] * embeds.shape[0]
    if paged:
        assert len(slot.pages) == -(-embeds.shape[0] // 64)
    req = s.submit(TURN, max_new_tokens=N_NEW, temperature=0.0, lease=lease)
    s.run()
    assert req.error is None and side.error is None
    assert side.out == ref_text
    if req.out != want:
        # a padded chunk's rows may differ in the last bits: equal up to
        # the port Engine's first near-tie
        eng.reset()
        eng.prefill_embeds(torch.from_numpy(embeds), want_logits=False)
        logits = eng.prefill(TURN)
        margins = []
        for t in want:
            top = torch.topk(logits, 2).values
            margins.append(float((top[0] - top[1]) / logits.abs().max()))
            logits = eng.decode_step(t)
        close = [i for i, m in enumerate(margins) if m < 1e-2]
        n_eq = close[0] if close else N_NEW
        assert n_eq >= 4 and req.out[:n_eq] == want[:n_eq]
    s.end_conversation(lease)


@pytest.mark.parametrize("paged", [True, False])
def test_image_rows_are_never_forked(mm, jax_side, paged):
    """A resident conversation (a text turn, then an image, then a turn):
    a new prompt that shares its text prefix forks those rows and stops at
    the first image row, whatever follows."""
    _, _, cfg, params, _ = mm
    embeds = jax_side[2][:40]
    s = _sched(cfg, params, paged, prefix_cache_min=4)
    lease = s.new_conversation()
    first = list(range(100, 120))
    s.submit(first, max_new_tokens=4, temperature=0.0, lease=lease)
    s.run()
    slot = s.slots[lease.slot_idx]
    pos0 = slot.pos                          # the text rows now cached
    assert pos0 == len(first) + 3
    s.prefill_embeds(lease, torch.from_numpy(embeds))
    assert slot.tokens[:pos0] == (first + slot.tokens[len(first):pos0])
    assert slot.tokens[pos0:] == [-1] * len(embeds)
    s.submit(TURN, max_new_tokens=4, temperature=0.0, lease=lease)
    s.run()
    shared = slot.tokens[:pos0]
    for tail in ([5, 6, 7, 8], TURN):
        saved0 = s.prefix_tokens_saved
        req = s.submit(shared + tail, max_new_tokens=4, temperature=0.0)
        s.run()
        assert req.error is None
        assert s.prefix_tokens_saved - saved0 == pos0
        ref = Engine(cfg, params, device="cpu", prefill_chunk=64).generate(
            shared + tail, GenerationConfig(temperature=0.0,
                                            max_new_tokens=4))
        assert req.out == ref
    n, donor = s._best_prefix(slot.tokens[:pos0] + [-1] * 8 + [1],
                              exclude=-1)
    assert (n, donor) == (pos0, lease.slot_idx)
    s.end_conversation(lease)


def test_prefill_embeds_context_overflow_raises(mm):
    _, _, cfg, params, _ = mm
    rows = torch.zeros(SEQ_LEN + 1, cfg.dim)
    eng = Engine(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="context overflow"):
        eng.prefill_embeds(rows)
    assert eng.pos == 0
    eng.prefill_embeds(rows[:SEQ_LEN - 4], want_logits=False)
    with pytest.raises(ValueError, match="context overflow"):
        eng.prefill_embeds(rows[:5])
    assert eng.pos == SEQ_LEN - 4
    with pytest.raises(ValueError, match="empty prompt"):
        eng.prefill_embeds(rows[:0])
    for paged in (True, False):
        s = _sched(cfg, params, paged, max_ctx=128)
        lease = s.new_conversation()
        with pytest.raises(ValueError, match="exceeds max context"):
            s.prefill_embeds(lease, rows[:128])
        assert s.slots[lease.slot_idx].pos == 0
        s.prefill_embeds(lease, rows[:120])
        with pytest.raises(ValueError, match="exceeds max context"):
            s.prefill_embeds(lease, rows[:8])
        assert s.slots[lease.slot_idx].pos == 120


@pytest.mark.parametrize("paged", [True, False])
def test_scheduler_prefill_embeds_runs_no_classifier(mm, monkeypatch,
                                                     paged):
    """An image's rows through a lease sample nothing, so no chunk of
    them runs the classifier (the Engine's want_logits=False); the turn
    after them does."""
    import lmrs_tpu_torch.models.transformer as tt

    _, _, cfg, params, _ = mm
    calls = []
    classify = tt._classify

    def counting(*a, **kw):
        calls.append(1)
        return classify(*a, **kw)

    monkeypatch.setattr(tt, "_classify", counting)
    s = _sched(cfg, params, paged)
    lease = s.new_conversation()
    s.prefill_embeds(lease, torch.zeros(150, cfg.dim))   # 3 chunks of 64
    assert s.slots[lease.slot_idx].pos == 150 and not calls
    req = s.submit(TURN, max_new_tokens=2, temperature=0.0, lease=lease)
    s.run()
    assert req.error is None and calls
    s.end_conversation(lease)


def test_scheduler_prefill_embeds_pool_exhausted_keeps_the_slot(mm):
    """A paged pool that cannot hold an image's rows: PoolExhausted, the
    slot keeps its pos, rows and pages and gives back the pages it took;
    rows that fit go in afterwards."""
    from lmrs_tpu_torch.serve.scheduler import PoolExhausted

    _, _, cfg, params, _ = mm
    s = BatchScheduler(cfg, params, max_batch=2, prefill_chunk=64,
                       decode_chunk=4, device="cpu", pool_tokens=192,
                       page_size=64)
    lease = s.new_conversation()
    rows = torch.zeros(200, cfg.dim)
    s.prefill_embeds(lease, rows[:40])
    slot = s.slots[lease.slot_idx]
    assert (slot.pos, len(slot.pages), s.pages_used()) == (40, 1, 1)
    with pytest.raises(PoolExhausted):
        s.prefill_embeds(lease, rows)
    assert (slot.pos, len(slot.pages), s.pages_used()) == (40, 1, 1)
    assert slot.tokens == [-1] * 40
    assert not s._table[lease.slot_idx, 1:].any()
    s.prefill_embeds(lease, rows[:100])
    assert (slot.pos, len(slot.pages), s.pages_used()) == (140, 3, 3)
    s.end_conversation(lease)
    assert s.pages_used() == 0
