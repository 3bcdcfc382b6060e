"""Tensor parallelism of the port (`parallel.tp`, `config.local_config`,
`parallel.sharding`; CPU, two gloo rank processes) against the JAX
package: the sharded loader's per-rank blocks against the JAX
`build_tp_params_stacked` global arrays, bit for bit; `local_config` and
the indivisible cases against JAX `local_config` / `_check_divisible`; and
the tp = 2 mesh Engine on tiny-llama Q8_0 and tiny-gemma Q4_0 (softcaps)
against the port's one-device Engine and the JAX single-device forward:
greedy tokens, teacher-forced logits, the int8 and int4 caches,
speculative greedy decoding, image-style embedding rows, and sessions
saved on tp = 2 and loaded on one device and the other way round.

Tolerances (tests/torch_mesh_cases.py): against the port's one-device
path 1e-3 of the logit scale + 1e-5, against JAX 1e-2 + 1e-4; greedy
tokens agree up to the first near-tie at those bounds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

import lmrs_tpu.io.lmrs as jl
from lmrs_tpu.config import PRESETS as JAX_PRESETS
from lmrs_tpu.parallel.tp import build_tp_params_stacked
from lmrs_tpu.parallel.tp import local_config as jax_local_config

from lmrs_tpu_torch.config import (PRESETS, ModelType, QuantType,
                                   local_config)
from lmrs_tpu_torch.io.lmrs import read_lmrs
from lmrs_tpu_torch.parallel.distributed import Mesh
from lmrs_tpu_torch.parallel.sharding import (COLUMN, ROW, VOCAB,
                                              tp_param_shardings)
from lmrs_tpu_torch.parallel.tp import make_mesh_engine, tp_params
from lmrs_tpu_torch.runtime.engine import GenerationConfig
from torch_mesh_cases import (GEMMA_SEED, JAX_TOL, LLAMA_SEED, PROMPT,
                              SELF_TOL, agree_until_tie, assert_close,
                              greedy, open_model, single_engine,
                              teacher_logits, write_model)

torch.set_num_threads(1)

N_NEW = 12


def jax_teacher_logits(path, tokens, **overrides):
    """The JAX single-device forward's logits of every row of `tokens`
    (one teacher-forced pass over the prompt and the stream)."""
    from functools import partial

    from lmrs_tpu.io.params import params_from_lmrs as jax_params
    from lmrs_tpu.models.transformer import embed_tokens as jax_embed
    from lmrs_tpu.models.transformer import forward as jax_forward
    from lmrs_tpu.models.transformer import init_kv_cache as jax_cache

    jf = jl.read_lmrs(path)
    jcfg = jf.cfg.replace(matmul_impl="fast", **overrides)
    jp = jax_params(jf, stack_layers=True, fuse_qkv=True)
    fwd = jax.jit(partial(jax_forward, cfg=jcfg, attn_len=jcfg.seq_len,
                          logit_idx="all"))
    x = jax_embed(jp, jcfg, jnp.asarray(tokens, jnp.int32))
    logits, _ = fwd(jp, cache=jax_cache(jcfg, jnp.bfloat16), x=x,
                    pos=jnp.int32(0))
    return np.asarray(logits)


@pytest.mark.parametrize("family,quant", [(ModelType.LLAMA, QuantType.Q8_0),
                                          (ModelType.GEMMA, QuantType.Q4_0)])
def test_sharded_loader_matches_jax_blocks(tmp_path, family, quant):
    """Rank r's blocks are the JAX stacked TP params' r-th contiguous
    blocks: wqkv/w13 rows [q_r; k_r; v_r] / [gate_r; up_r], wo/w2 input
    columns and their scale groups, embed rows; norms and RoPE whole."""
    path = write_model(tmp_path, family, quant)
    f = read_lmrs(path)
    jf = jl.read_lmrs(path)
    jmesh = JMesh(np.asarray(jax.devices()[:2]), ("tp",))
    jp, _ = build_tp_params_stacked(jf.cfg, jf.tensors, jmesh)
    for r in range(2):
        tp = tp_params(f, f.cfg, 2, r, "cpu")
        for name in ("wqkv", "wo", "w13", "w2"):
            jq = getattr(jp.layers, name)
            for part, axis in (("q", 1), ("s", 1)):
                glob = np.asarray(getattr(jq, part))
                if name in ("wo", "w2"):
                    n = glob.shape[2] // 2
                    want = glob[:, :, r * n:(r + 1) * n]
                else:
                    n = glob.shape[axis] // 2
                    want = glob[:, r * n:(r + 1) * n]
                for layer, lw in enumerate(tp.layers):
                    got = getattr(getattr(lw, name), part)
                    assert got.is_contiguous() and got.data_ptr() % 16 == 0
                    np.testing.assert_array_equal(got.numpy(), want[layer])
        for part in ("q", "s"):
            glob = np.asarray(getattr(jp.embed, part))
            n = glob.shape[0] // 2
            np.testing.assert_array_equal(
                getattr(tp.embed, part).numpy(), glob[r * n:(r + 1) * n])
        np.testing.assert_array_equal(tp.final_norm.numpy(),
                                      np.asarray(jp.final_norm))
        np.testing.assert_array_equal(tp.layers[1].att_norm.numpy(),
                                      np.asarray(jp.layers.att_norm)[1])


@pytest.mark.parametrize("name", ["llama3.2-3b", "gemma2-9b", "tiny-llama",
                                  "phi3.5-mini"])
@pytest.mark.parametrize("tp", [2, 4])
def test_local_config_matches_jax(name, tp):
    cfg = PRESETS[name]()
    mine = local_config(cfg, tp, cp=2)
    theirs = jax_local_config(JAX_PRESETS[name](), tp, "tp", "cp", cp=2)
    assert (mine.n_heads, mine.n_kv_heads, mine.hidden_dim, mine.dim) == \
        (theirs.n_heads, theirs.n_kv_heads, theirs.hidden_dim, theirs.dim)
    assert (mine.tp_axis, mine.cp_axis, mine.cp_degree) == \
        (theirs.tp_axis, theirs.cp_axis, theirs.cp_degree) == ("tp", "cp", 2)
    plan = tp_param_shardings(cfg, tp)
    assert {plan["wq"], plan["w1"]} == {COLUMN} and plan["wo"] == ROW
    assert plan["embed"] == VOCAB


def test_tp_rejects_indivisible():
    """The JAX test_tp_rejects_indivisible case (4 ranks, 2 kv heads), and
    every other indivisible axis, raise as the JAX `_check_divisible`."""
    from lmrs_tpu.io.synthetic import tiny_config as jax_tiny
    from lmrs_tpu.quant import QuantType as JQuantType
    from lmrs_tpu.config import ModelType as JModelType
    from lmrs_tpu.parallel.tp import _check_divisible

    from lmrs_tpu_torch.io.synthetic import tiny_config

    for kw in (dict(n_kv_heads=2, vocab_size=512), dict(vocab_size=514),
               dict(hidden_dim=96), dict(n_heads=6, n_kv_heads=6)):
        cfg = tiny_config(ModelType.LLAMA, QuantType.Q8_0, **kw)
        with pytest.raises(ValueError) as jerr:
            _check_divisible(jax_tiny(JModelType.LLAMA, JQuantType.Q8_0,
                                      **kw), 4)
        with pytest.raises(ValueError, match="tp=4 incompatible") as err:
            local_config(cfg, 4)
        assert str(err.value) == str(jerr.value)
        with pytest.raises(ValueError, match="tp=4 incompatible"):
            Mesh.start(type("F", (), {"cfg": cfg, "path": "-"})(), tp=4,
                       device="cpu")


@pytest.fixture(scope="module")
def llama(tmp_path_factory):
    """tiny-llama Q8_0 on a tp = 2 mesh, its one-device engine, and the
    one-device greedy stream of PROMPT."""
    d = tmp_path_factory.mktemp("tp_llama")
    path = write_model(d, ModelType.LLAMA, QuantType.Q8_0, **LLAMA_SEED)
    f = open_model(path)
    mesh = Mesh.start(f, tp=2, device="cpu", timeout=120)
    one = single_engine(f, prefill_chunk=16)
    want = greedy(one, PROMPT, N_NEW)
    assert len(set(want)) >= 3
    yield dict(path=path, f=f, mesh=mesh, one=one, want=want, dir=d)
    mesh.shutdown()


def test_tp_engine_matches_one_device_and_jax(llama):
    """The mesh Engine (chunked prefill, decode): greedy tokens twice
    across reset(), teacher-forced logits against the one-device engine
    (tight) and the JAX forward; the collectives ran on both ranks."""
    eng = make_mesh_engine(llama["f"], mesh=llama["mesh"], prefill_chunk=16)
    llama["mesh"].reset_stats()
    got = greedy(eng, PROMPT, N_NEW)
    assert greedy(eng, PROMPT, N_NEW) == got
    stats = llama["mesh"].stats()
    # 2 sums a layer, the embedding's sum and the logits' gather, a call
    assert stats["collectives"][0] == stats["collectives"][1] > 0
    mine = teacher_logits(eng, PROMPT, llama["want"])
    one = teacher_logits(llama["one"], PROMPT, llama["want"])
    assert_close(mine, one, SELF_TOL)
    agree_until_tie(got, llama["want"], one, SELF_TOL)
    jax_all = jax_teacher_logits(llama["path"], PROMPT + llama["want"])
    jax_rows = jax_all[len(PROMPT) - 1:len(PROMPT) - 1 + N_NEW]
    assert_close(mine, jax_rows, JAX_TOL)
    # the JAX stream's near-ties at its 1e-2 bound come early here
    agree_until_tie(got, [int(t) for t in jax_rows.argmax(-1)], jax_rows,
                    JAX_TOL, min_steps=0)
    eng.close()


@pytest.mark.parametrize("cache_dtype", ["int8", "int4"])
def test_tp_quantized_caches(llama, cache_dtype):
    """int8 and int4 caches on the local kv heads (the int4 packing of
    2 local heads) against the one-device engine of the same cache."""
    eng = make_mesh_engine(llama["f"], mesh=llama["mesh"], prefill_chunk=16,
                           cache_dtype=cache_dtype)
    one = single_engine(llama["f"], prefill_chunk=16,
                        cache_dtype=cache_dtype)
    want = greedy(one, PROMPT, N_NEW)
    got = greedy(eng, PROMPT, N_NEW)
    ref = teacher_logits(one, PROMPT, want)
    assert_close(teacher_logits(eng, PROMPT, want), ref, SELF_TOL)
    agree_until_tie(got, want, ref, SELF_TOL)
    eng.close()


def test_tp_speculative_and_embeds(llama):
    """Speculative greedy decoding (k = 3: verify windows of 4 rows through
    the sharded forward) gives the plain greedy tokens; float rows (an
    image's) go to every rank: prefill_embeds of the prompt's own
    embedding rows equals prefilling the tokens."""
    eng = make_mesh_engine(llama["f"], mesh=llama["mesh"], prefill_chunk=16)
    spec = greedy(eng, PROMPT + PROMPT[:12], N_NEW, speculative_k=3)
    assert eng.metrics.spec_proposed > 0
    assert spec == greedy(eng, PROMPT + PROMPT[:12], N_NEW)
    eng.reset()
    rows = llama["mesh"].embed(torch.tensor(PROMPT))
    one = llama["one"]
    one.reset()
    from lmrs_tpu_torch.models.transformer import embed_tokens

    want_rows = embed_tokens(one.params, one.cfg, torch.tensor(PROMPT))
    np.testing.assert_allclose(rows.numpy(), want_rows.numpy(), rtol=0,
                               atol=1e-6)
    got = eng.prefill_embeds(rows)
    want = one.prefill(PROMPT)
    assert_close(got.numpy()[None], want.numpy()[None], SELF_TOL)
    eng.close()


def test_tp_sessions_cross_tp_and_one_device(llama, tmp_path):
    """A session saved on tp = 2 after the prompt and 4 tokens loads into
    the one-device engine and continues as the tp = 2 engine does, and a
    one-device session loads into the tp = 2 engine; the files carry the
    JAX package's keys and global shapes."""
    f = llama["f"]
    for cache_dtype in ("bfloat16", "int4"):
        eng = make_mesh_engine(f, mesh=llama["mesh"], prefill_chunk=16,
                               cache_dtype=cache_dtype)
        one = single_engine(f, prefill_chunk=16, cache_dtype=cache_dtype)
        first = greedy(eng, PROMPT, 5)
        path = str(tmp_path / f"tp_{cache_dtype}.npz")
        eng.save_session(path)
        with np.load(path) as z:
            assert set(z.files) >= {"k", "v", "pos", "hist", "sig"}
            assert z["k"].shape == (f.cfg.n_layers, f.cfg.seq_len,
                                    f.cfg.n_kv_heads * f.cfg.head_dim
                                    // (2 if cache_dtype == "int4" else 1))
        def gen_next(e):
            return e.generate([first[-1]], GenerationConfig(
                temperature=0.0, max_new_tokens=6))

        cont = gen_next(eng)
        one.load_session(path)
        assert gen_next(one) == cont
        # and back: the one-device session into the mesh
        one2 = single_engine(f, prefill_chunk=16, cache_dtype=cache_dtype)
        greedy(one2, PROMPT, 5)
        path2 = str(tmp_path / f"one_{cache_dtype}.npz")
        one2.save_session(path2)
        want = gen_next(one2)
        eng.load_session(path2)
        assert eng.pos == len(PROMPT) + 4
        assert gen_next(eng) == want
        eng.close()


def test_tp_gemma_softcaps_match_jax(tmp_path):
    """tiny-gemma Q4_0 (attention and final softcaps, the sqrt(dim)
    embedding scale after the tp sum, Q4 blocks split at group edges) on
    tp = 2 against the one-device engine and the JAX forward."""
    path = write_model(tmp_path, ModelType.GEMMA, QuantType.Q4_0,
                       **GEMMA_SEED)
    f = open_model(path)
    one = single_engine(f, prefill_chunk=16)
    want = greedy(one, PROMPT, N_NEW)
    eng = make_mesh_engine(f, tp=2, device="cpu", prefill_chunk=16)
    try:
        got = greedy(eng, PROMPT, N_NEW)
        mine = teacher_logits(eng, PROMPT, want)
    finally:
        eng.mesh.shutdown()
    ref = teacher_logits(one, PROMPT, want)
    assert_close(mine, ref, SELF_TOL)
    agree_until_tie(got, want, ref, SELF_TOL)
    jax_rows = jax_teacher_logits(path, PROMPT + want)[
        len(PROMPT) - 1:len(PROMPT) - 1 + N_NEW]
    assert_close(mine, jax_rows, JAX_TOL)
