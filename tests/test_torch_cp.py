"""Context parallelism of the port (the KV cache's sequence axis sharded
over cp ranks; CPU, gloo) against the JAX package: the row-exact cp
write against the JAX `cp_masked_write` and the shard merge against the
JAX `attention_cp`, both under shard_map on 2 of the 8 virtual CPU
devices; then cp = 2 and tp x cp = 2 x 2 mesh Engines (the sequence-
parallel prefill, a prompt across the shard edge, decode through the cp
partials, int8 and int4 caches, speculative windows that straddle the
edge, Gemma's window inside a shard) against the port's one-device Engine
and the JAX single-device forward.

Tolerances: the cp write bit for bit; the merge within 2e-2 of the
output scale + 1e-3 of the JAX f32 einsum (the port's partials round q,
k, v and the weights to bf16, as kernel B1 does); engines as
tests/torch_mesh_cases.py states (5e-3 of the logit scale against the
port's one-device path: the shards round their softmax weights against
their own max; 1e-2 against JAX; greedy tokens up to the first
near-tie).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from lmrs_tpu_torch.config import ModelType, QuantType
from lmrs_tpu_torch.models.transformer import (KVCache, _cp_write_batched,
                                               _cp_write_index, cp_merge,
                                               cp_partials, cp_write)
from lmrs_tpu_torch.parallel.distributed import Mesh
from lmrs_tpu_torch.parallel.tp import make_mesh_engine
from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig
from test_torch_tp import jax_teacher_logits
from torch_mesh_cases import (CP_TOL, GEMMA_SEED, JAX_TOL, LLAMA_SEED,
                              ROUNDING_TOL,
                              agree_until_tie, assert_close, greedy,
                              open_model, run_ranks, single_engine,
                              teacher_logits, write_model)

torch.set_num_threads(1)

N_NEW = 10
# 300 prompt rows: the context crosses the 256-row shard edge of a
# 512-row context on 2 ranks; the last chunk of 64 (44 rows) is even
LONG = [int(t) for t in np.random.default_rng(1).integers(3, 2000, 300)]


def test_cp_write_matches_jax_masked_write():
    """A T-row window at any global position, aligned, interior or
    straddling the shard edge, lands as the JAX cp_masked_write (and
    cp_masked_write_scales) lands it; the per-slot form does the same for
    slots at their own positions."""
    from lmrs_tpu.models.transformer import (cp_masked_write,
                                             cp_masked_write_scales)

    L, S, M, KH, T = 2, 32, 8, 4, 4          # 2 shards of 16 rows
    rng = np.random.default_rng(5)
    base = rng.standard_normal((L, S, M)).astype(np.float32)
    rows = rng.standard_normal((T, M)).astype(np.float32)
    s_base = rng.standard_normal((L, KH, S)).astype(np.float32)
    srows = rng.standard_normal((T, KH)).astype(np.float32)
    jmesh = JMesh(np.asarray(jax.devices()[:2]), ("cp",))

    def wr(c, r, s_arr, sr, pos):
        return (cp_masked_write(c, r, jnp.int32(1), pos, S // 2, "cp"),
                cp_masked_write_scales(s_arr, sr, jnp.int32(1), pos,
                                       S // 2, "cp"))

    sm = jax.jit(jax.shard_map(
        wr, mesh=jmesh,
        in_specs=(P(None, "cp", None), P(), P(None, None, "cp"), P(), P()),
        out_specs=(P(None, "cp", None), P(None, None, "cp")),
        check_vma=False))
    for pos in (0, 3, 13, 14, 16, 28):
        want, want_s = (np.asarray(a) for a in sm(
            base, rows, s_base, srows, jnp.int32(pos)))
        shards = []
        for r in range(2):
            c = KVCache(torch.tensor(base[:, 16 * r:16 * (r + 1)]),
                        torch.tensor(base[:, 16 * r:16 * (r + 1)]),
                        torch.tensor(s_base[:, :, 16 * r:16 * (r + 1)]),
                        torch.tensor(s_base[:, :, 16 * r:16 * (r + 1)]))
            cp_write(c, 1, pos, torch.tensor(np.stack([rows, rows])),
                     torch.tensor(np.stack([srows, srows])), 16 * r)
            shards.append(c)
        np.testing.assert_array_equal(
            torch.cat([c.k for c in shards], 1).numpy(), want)
        np.testing.assert_array_equal(
            torch.cat([c.v_scale for c in shards], 2).numpy(), want_s)
    # the per-slot form: 3 slots at 13 (straddling), 0 and 28
    pos = torch.tensor([13, 0, 28], dtype=torch.int32)
    b_rows = rng.standard_normal((3 * T, M)).astype(np.float32)
    b_sc = rng.standard_normal((3 * T, KH)).astype(np.float32)
    per_slot = np.stack([base] * 3)                        # (B, L, S, M)
    per_slot_s = np.stack([s_base] * 3)
    want, want_s = per_slot.copy(), per_slot_s.copy()
    for b, p in enumerate(pos.tolist()):
        want[b, 1, p:p + T] = b_rows[b * T:(b + 1) * T]
        want_s[b, 1, :, p:p + T] = b_sc[b * T:(b + 1) * T].T
    got, got_s = [], []
    for r in range(2):
        blk = torch.tensor(per_slot[:, :, 16 * r:16 * (r + 1)])
        sblk = torch.tensor(per_slot_s[..., 16 * r:16 * (r + 1)])
        c = KVCache(blk, blk.clone(), sblk, sblk.clone())
        dest = _cp_write_index(c, pos, T, 16 * r)
        _cp_write_batched(c, 1, dest, torch.tensor(np.stack([b_rows] * 2)),
                          torch.tensor(np.stack([b_sc] * 2)))
        got.append(c.k)
        got_s.append(c.k_scale)
    np.testing.assert_array_equal(torch.cat(got, 2).numpy(), want)
    np.testing.assert_array_equal(torch.cat(got_s, 3).numpy(), want_s)


@pytest.mark.parametrize("t_q,pos,window", [(1, 20, None), (5, 13, None),
                                            (3, 27, 8), (24, 4, None)])
def test_cp_merge_matches_jax_attention_cp(t_q, pos, window):
    """Each shard's partials (B1's plain version for a decode call, plain
    torch ops for a 24-row chunk), merged over 2 gloo ranks (a max, then
    one sum), against the JAX attention_cp under shard_map; a shard with
    no live key for a row (pos 4: shard 1 holds rows 16..31) weighs 0."""
    from lmrs_tpu.ops.attention import attention_cp
    from lmrs_tpu_torch.config import tiny_llama

    S, KH, G, HD = 32, 2, 4, 32
    cfg = tiny_llama().replace(n_heads=KH * G, n_kv_heads=KH, head_dim=HD,
                               sliding_window=window,
                               attn_logit_softcap=20.0)
    rng = np.random.default_rng(t_q)
    q = rng.standard_normal((t_q, KH * G, HD)).astype(np.float32)
    k = rng.standard_normal((S, KH, HD)).astype(np.float32)
    v = rng.standard_normal((S, KH, HD)).astype(np.float32)
    jmesh = JMesh(np.asarray(jax.devices()[:2]), ("cp",))
    want = np.asarray(jax.jit(jax.shard_map(
        lambda q, k, v: attention_cp(q, k, v, jnp.int32(pos), "cp",
                                     scale=cfg.attn_scale, softcap=20.0,
                                     window=window),
        mesh=jmesh, in_specs=(P(), P("cp"), P("cp")), out_specs=P(),
        check_vma=False))(q, k, v))

    def rank(comm):
        r = comm.cp_rank
        blk = lambda a: torch.tensor(  # noqa: E731
            a[16 * r:16 * (r + 1)].reshape(1, 1, 16, KH * HD))
        cache = KVCache(blk(k), blk(v))
        parts = cp_partials(cfg, torch.tensor(q)[None], cache, 0,
                            torch.tensor([pos], dtype=torch.int32), 16 * r)
        if pos + t_q <= 16 and r == 1:
            assert (parts[1] == torch.finfo(torch.float32).min).all()
        return cp_merge(*parts, comm)[0].numpy()

    got = run_ranks(2, 1, 2, rank)
    np.testing.assert_array_equal(got[0], got[1])   # the same bits
    err = np.abs(got[0] - want).max()
    assert err <= 2e-2 * np.abs(want).max() + 1e-3, err


@pytest.fixture(scope="module")
def llama(tmp_path_factory):
    d = tmp_path_factory.mktemp("cp_llama")
    path = write_model(d, ModelType.LLAMA, QuantType.Q8_0, **LLAMA_SEED)
    f = open_model(path)
    mesh = Mesh.start(f, cp=2, device="cpu", timeout=120)
    one = single_engine(f, prefill_chunk=64)
    want = greedy(one, LONG, N_NEW)
    yield dict(path=path, f=f, mesh=mesh, one=one, want=want)
    mesh.shutdown()


def test_cp_engine_across_the_shard_edge(llama):
    """cp = 2: a 300-token prompt in 64-row sequence-parallel chunks (each
    rank projects 32 rows) and decode steps through the cp partials, past
    the 256-row shard edge; greedy tokens and teacher-forced logits
    against the one-device engine and the JAX forward; 1-row chunks (no
    sequence parallelism, the decode path) give the one-device engine's
    logits too."""
    f, mesh = llama["f"], llama["mesh"]
    eng = make_mesh_engine(f, mesh=mesh, prefill_chunk=64)
    got = greedy(eng, LONG, N_NEW)
    mine = teacher_logits(eng, LONG, llama["want"])
    one = teacher_logits(llama["one"], LONG, llama["want"])
    assert_close(mine, one, CP_TOL)
    agree_until_tie(got, llama["want"], one, CP_TOL)
    jax_rows = jax_teacher_logits(llama["path"], LONG + llama["want"])[
        len(LONG) - 1:len(LONG) - 1 + N_NEW]
    assert_close(mine, jax_rows, JAX_TOL)
    # 1-row chunks take the T <= 8 (W8A8) matmuls: against the one-device
    # engine's 1-row chunks
    rowwise = make_mesh_engine(f, mesh=mesh, prefill_chunk=1)
    one_rowwise = single_engine(f, prefill_chunk=1)
    assert_close(rowwise.prefill(LONG[:70]).numpy()[None],
                 one_rowwise.prefill(LONG[:70]).numpy()[None], ROUNDING_TOL)
    with pytest.raises(ValueError, match="must divide the local cache"):
        Engine(f.cfg, mesh.params, mesh=mesh, prefill_chunk=96)
    eng.close()
    rowwise.close()


@pytest.mark.parametrize("cache_dtype", ["int8", "int4"])
def test_cp_quantized_caches(llama, cache_dtype):
    eng = make_mesh_engine(llama["f"], mesh=llama["mesh"], prefill_chunk=64,
                           cache_dtype=cache_dtype)
    one = single_engine(llama["f"], prefill_chunk=64,
                        cache_dtype=cache_dtype)
    want = greedy(one, LONG, N_NEW)
    got = greedy(eng, LONG, N_NEW)
    ref = teacher_logits(one, LONG, want)
    assert_close(teacher_logits(eng, LONG, want), ref, ROUNDING_TOL)
    agree_until_tie(got, want, ref, ROUNDING_TOL)
    eng.close()


def test_cp_speculative_windows_straddle_the_edge(llama):
    """Speculative greedy decoding (k = 4) from position 250: verify
    windows of 5 rows land across the 256-row edge, part on each shard,
    and the tokens are the plain greedy ones."""
    eng = make_mesh_engine(llama["f"], mesh=llama["mesh"], prefill_chunk=64)
    prompt = LONG[:230] + LONG[:20]                # repeats: drafts hit
    plain = greedy(eng, prompt, 16)
    spec = greedy(eng, prompt, 16, speculative_k=4)
    assert eng.metrics.spec_proposed > 0
    assert spec == plain
    eng.close()


def test_cp_gemma_window_inside_a_shard(tmp_path):
    """tiny-gemma Q4_0 with a 64-row window (its edge inside a shard, in
    global positions through seq_base) and softcaps on cp = 2, against the
    one-device engine and the JAX forward with the same window."""
    path = write_model(tmp_path, ModelType.GEMMA, QuantType.Q4_0,
                       **GEMMA_SEED)
    f = open_model(path, sliding_window=64)
    one = single_engine(f, prefill_chunk=64)
    want = greedy(one, LONG, N_NEW)
    eng = make_mesh_engine(f, cp=2, device="cpu", prefill_chunk=64)
    try:
        got = greedy(eng, LONG, N_NEW)
        mine = teacher_logits(eng, LONG, want)
    finally:
        eng.mesh.shutdown()
    ref = teacher_logits(one, LONG, want)
    assert_close(mine, ref, CP_TOL)
    agree_until_tie(got, want, ref, CP_TOL)
    jax_rows = jax_teacher_logits(path, LONG + want, sliding_window=64)[
        len(LONG) - 1:len(LONG) - 1 + N_NEW]
    assert_close(mine, jax_rows, JAX_TOL)


def test_tp_by_cp_engine(llama):
    """tp x cp = 2 x 2 (four ranks: heads on tp, the sequence on cp): the
    one-device engine's greedy tokens and logits."""
    eng = make_mesh_engine(llama["f"], tp=2, cp=2, device="cpu",
                           prefill_chunk=64)
    try:
        assert (eng.mesh.comm.tp, eng.mesh.comm.cp) == (2, 2)
        got = greedy(eng, LONG, N_NEW)
        mine = teacher_logits(eng, LONG, llama["want"])
    finally:
        eng.mesh.shutdown()
    one = teacher_logits(llama["one"], LONG, llama["want"])
    assert_close(mine, one, CP_TOL)
    agree_until_tie(got, llama["want"], one, CP_TOL)


def test_cp_session_across_the_shard_edge(llama, tmp_path):
    """A session saved on cp = 2 at position 283 (its rows on both shards)
    holds the global layout: layer 0's K rows are the one-device engine's
    (they depend on no attention; 1e-2 of their scale: bf16 rows of
    matmuls in another row split), and it resumes on a fresh cp = 2 engine
    as the saving engine continues, token for token."""
    f, mesh = llama["f"], llama["mesh"]
    eng = make_mesh_engine(f, mesh=mesh, prefill_chunk=64)
    first = greedy(eng, LONG[:280], 4)
    path = str(tmp_path / "cp.npz")
    eng.save_session(path)
    with np.load(path) as z:
        k0 = z["k"][0, :eng.pos].view(np.int16)
    one = llama["one"]
    greedy(one, LONG[:280], 4)
    want = one.cache.k[0, :eng.pos].view(torch.int16).numpy()
    k0, want = (torch.from_numpy(a).view(torch.bfloat16).float()
                for a in (k0, want))
    assert (k0 - want).abs().max() <= 1e-2 * want.abs().max()
    gen = GenerationConfig(temperature=0.0, max_new_tokens=6)
    cont = eng.generate([first[-1]], gen)
    fresh = make_mesh_engine(f, mesh=mesh, prefill_chunk=64)
    fresh.load_session(path)
    assert fresh.pos == 283
    assert fresh.generate([first[-1]], gen) == cont
    eng.close()
    fresh.close()
