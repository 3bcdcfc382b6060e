"""The port's exporter and safetensors reader (CPU) against the JAX
package's exporter and the `safetensors` package: a local fake Hugging
Face checkpoint per family (Gemma, Llama, Phi, and Phi with its vision
tower), written in BF16 by `safetensors.torch`.

Tolerances: the .lmrs files byte for byte, and the exporters' printed
reports line for line; the reader's tensors bit for bit against
`safe_open(...).get_tensor(k).float()` (BF16 and F16 widen exactly); the
exported f32 model's logits within 1e-5 of the logit scale of the JAX
package's logits on the JAX export (f32 products and f32 KV caches, sums
in another order).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file

import jax.numpy as jnp
from lmrs_tpu.io.export import export as jax_export
from lmrs_tpu.io.lmrs import read_lmrs as jax_read_lmrs
from lmrs_tpu.io.params import params_from_lmrs as jax_params_from_lmrs
from lmrs_tpu.runtime.engine import Engine as JaxEngine

from lmrs_tpu_torch.config import ModelConfig, ModelType, QuantType
from lmrs_tpu_torch.io.export import main as export_main
from lmrs_tpu_torch.io.lmrs import read_lmrs
from lmrs_tpu_torch.io.params import params_from_lmrs
from lmrs_tpu_torch.io.safetensors import SafetensorsFile, SafetensorsSource
from lmrs_tpu_torch.io.synthetic import tiny_config
from lmrs_tpu_torch.models.transformer import (embed_tokens, forward,
                                               init_kv_cache)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
V = "model.vision_embed_tokens"
VISION = dict(hidden_size=32, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=2, layer_norm_eps=1e-5, patch_size=14,
              image_size=336)


def hf_tensors(cfg: ModelConfig, family: str, seed: int,
               vision: bool = False):
    """{HF name: float32 array} of a tiny checkpoint: std 0.02, norms near
    1; with `vision`, Phi-3.5-vision's CLIP tower and projector too."""
    rng = np.random.default_rng(seed)
    D, H, A, KV, Vs = (cfg.dim, cfg.hidden_dim, cfg.att_dim, cfg.kv_dim,
                       cfg.vocab_size)
    t = {}

    def add(name, shape, mean=0.0):
        t[name] = (mean + rng.normal(0, 0.02, shape)).astype(np.float32)

    add("model.embed_tokens.weight", (Vs, D))
    for l in range(cfg.n_layers):
        p = f"model.layers.{l}"
        add(f"{p}.input_layernorm.weight", (D,), 1.0)
        if family == "PHI":
            add(f"{p}.self_attn.qkv_proj.weight", (A + 2 * KV, D))
            add(f"{p}.mlp.gate_up_proj.weight", (2 * H, D))
        else:
            for n, o in (("q", A), ("k", KV), ("v", KV)):
                add(f"{p}.self_attn.{n}_proj.weight", (o, D))
            add(f"{p}.mlp.gate_proj.weight", (H, D))
            add(f"{p}.mlp.up_proj.weight", (H, D))
        add(f"{p}.self_attn.o_proj.weight", (D, A))
        add(f"{p}.mlp.down_proj.weight", (D, H))
        add(f"{p}.post_attention_layernorm.weight", (D,), 1.0)
        if family == "GEMMA":
            add(f"{p}.pre_feedforward_layernorm.weight", (D,))
            add(f"{p}.post_feedforward_layernorm.weight", (D,))
    add("model.norm.weight", (D,), 1.0)
    if family == "PHI":
        add("lm_head.weight", (Vs, D))
    if vision:
        vd, vh = VISION["hidden_size"], VISION["intermediate_size"]
        m = f"{V}.img_processor.vision_model"
        add(f"{m}.embeddings.class_embedding", (vd,))
        add(f"{m}.embeddings.patch_embedding.weight", (vd, 3, 14, 14))
        add(f"{m}.embeddings.position_embedding.weight", (577, vd))
        for l in range(VISION["num_hidden_layers"]):
            p = f"{m}.encoder.layers.{l}"
            for n in ("layer_norm1", "layer_norm2"):
                add(f"{p}.{n}.weight", (vd,), 1.0)
                add(f"{p}.{n}.bias", (vd,))
            for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                add(f"{p}.self_attn.{n}.weight", (vd, vd))
                add(f"{p}.self_attn.{n}.bias", (vd,))
            add(f"{p}.mlp.fc1.weight", (vh, vd))
            add(f"{p}.mlp.fc1.bias", (vh,))
            add(f"{p}.mlp.fc2.weight", (vd, vh))
            add(f"{p}.mlp.fc2.bias", (vd,))
        add(f"{m}.pre_layrnorm.weight", (vd,), 1.0)
        add(f"{m}.pre_layrnorm.bias", (vd,))
        add(f"{V}.glb_GN", (1, 1, vh))
        add(f"{V}.sub_GN", (1, 1, 1, vh))
        add(f"{V}.img_projection.0.weight", (D, vh))
        add(f"{V}.img_projection.0.bias", (D,))
        add(f"{V}.img_projection.2.weight", (D, D))
        add(f"{V}.img_projection.2.bias", (D,))
    return t


def write_checkpoint(tmp_path, cfg, family, seed=21, vision=False,
                     shards=2, dtype=torch.bfloat16):
    """The checkpoint in `shards` files (the embedding and the first
    layers in the first), its config.json and, with `vision`, the vision
    config file.  Returns (files, config path, vision config path)."""
    t = hf_tensors(cfg, family, seed, vision)
    names = list(t)
    cut = len(names) // 2 if shards == 2 else len(names)
    files = []
    for i, part in enumerate((names[:cut], names[cut:])[:shards]):
        path = str(tmp_path / f"model-{i + 1:05d}-of-{shards:05d}."
                   "safetensors")
        save_file({k: torch.from_numpy(t[k]).to(dtype) for k in part}, path)
        files.append(path)
    config = dict(
        hidden_size=cfg.dim, intermediate_size=cfg.hidden_dim,
        num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
        head_dim=cfg.head_dim, num_key_value_heads=cfg.n_kv_heads,
        vocab_size=cfg.vocab_size, max_position_embeddings=cfg.seq_len,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(config))
    vis_path = None
    if vision:
        vis_path = tmp_path / "vision_config.json"
        vis_path.write_text(json.dumps({"vision_config": VISION}))
    return files, str(cfg_path), vis_path and str(vis_path)


def family_config(family, **kw):
    if family == "PHI":
        # the fused qkv_proj splits into equal thirds: n_kv_heads == n_heads
        kw.setdefault("n_kv_heads", 4)
    return tiny_config(ModelType[family], QuantType.NONE, **kw)


CASES = [(f, q, False) for f in ("GEMMA", "LLAMA", "PHI")
         for q in (0, 1, 2)] + [("PHI", q, True) for q in (0, 1, 2)]


@pytest.mark.parametrize("family,qtype,vision", CASES)
def test_export_matches_jax_byte_for_byte(tmp_path, capsys, family, qtype,
                                          vision):
    gs = 16 if vision else 32
    cfg = family_config(family)
    files, cj, vj = write_checkpoint(tmp_path, cfg, family, vision=vision)
    args = dict(quantize=qtype > 0, quantize_type=max(qtype, 1),
                group_size=gs, vision_config=vj)
    capsys.readouterr()
    want = jax_export(files, cj, str(tmp_path / "jax"), family, **args)
    jax_out = capsys.readouterr().out
    argv = ["--files", *files, "--config", cj, "--save-path",
            str(tmp_path / "port"), "--type", family, "--group-size",
            str(gs)]
    if qtype:
        argv += ["--quantize", "--quantize-type", str(qtype)]
    if vj:
        argv += ["--vision-config", vj]
    export_main(argv)
    assert capsys.readouterr().out == jax_out
    got = Path(tmp_path / "port.lmrs").read_bytes()
    assert got == Path(want).read_bytes()
    f = read_lmrs(str(tmp_path / "port.lmrs"))
    assert f.cfg.model_type == ModelType[family]
    assert f.cfg.quant == QuantType(qtype) and f.cfg.multimodal == vision
    if vision:
        assert f.vision_cfg.n_layers == VISION["num_hidden_layers"]


def test_module_entry_point_writes_the_jax_bytes(tmp_path):
    """`python -m lmrs_tpu_torch.io.export`, Q4_0, one shard."""
    cfg = family_config("LLAMA")
    files, cj, _ = write_checkpoint(tmp_path, cfg, "LLAMA", shards=1)
    want = jax_export(files, cj, str(tmp_path / "jax"), "LLAMA",
                      quantize=True, quantize_type=2, group_size=32)
    out = subprocess.run(
        [sys.executable, "-m", "lmrs_tpu_torch.io.export", "--files",
         *files, "--config", cj, "--save-path", str(tmp_path / "port"),
         "--type", "LLAMA", "--quantize", "--quantize-type", "2",
         "--group-size", "32"], capture_output=True, text=True,
        timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert "Max quantization group error" in out.stdout
    assert (tmp_path / "port.lmrs").read_bytes() == Path(want).read_bytes()


def test_group_size_backoff(tmp_path, capsys):
    cfg = family_config("LLAMA")            # dim 64
    files, cj, _ = write_checkpoint(tmp_path, cfg, "LLAMA")
    capsys.readouterr()
    jax_export(files, cj, str(tmp_path / "jax"), "LLAMA", quantize=True,
               quantize_type=1, group_size=96)
    jax_out = capsys.readouterr().out
    export_main(["--files", *files, "--config", cj, "--save-path",
                 str(tmp_path / "port"), "--type", "LLAMA", "--quantize",
                 "--group-size", "96"])
    out = capsys.readouterr().out
    assert out == jax_out
    backoff = [ln for ln in out.splitlines() if ln.startswith("BACKOFF")]
    assert backoff[:2] == ["BACKOFF: reducing group size to 48 to fit "
                           "hidden_dim",
                           "BACKOFF: reducing group size to 24 to fit "
                           "hidden_dim"]
    f = read_lmrs(str(tmp_path / "port.lmrs"))
    assert cfg.dim % f.cfg.group_size == 0
    assert f.cfg.group_size == 96 >> len(backoff)
    assert (tmp_path / "port.lmrs").read_bytes() == \
        (tmp_path / "jax.lmrs").read_bytes()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_reader_matches_safe_open_bit_for_bit(tmp_path, dtype):
    cfg = family_config("GEMMA")
    files, _, _ = write_checkpoint(tmp_path, cfg, "GEMMA", dtype=dtype)
    src = SafetensorsSource(files)
    n = 0
    for path, mine in zip(files, src.files):
        with safe_open(path, framework="pt", device="cpu") as h:
            assert mine.keys() == list(h.keys())
            for k in h.keys():
                want = h.get_tensor(k).to(torch.float32).numpy()
                got = mine.get(k)
                assert got.dtype == np.float32 and got.shape == want.shape
                np.testing.assert_array_equal(got.view(np.uint32),
                                              want.view(np.uint32))
                n += 1
    assert len(src.keys()) == n
    # a per-layer collect spans both shards in layer order
    w1 = src.collect("mlp.gate_proj")
    assert len(w1) == cfg.n_layers
    for l, a in enumerate(w1):
        key = f"model.layers.{l}.mlp.gate_proj.weight"
        path = [p for p in files if key in safe_open(p, "pt").keys()][0]
        with safe_open(path, framework="pt") as h:
            want = h.get_tensor(key).to(torch.float32).numpy()
        np.testing.assert_array_equal(a, want)


def test_reader_skips_metadata_and_splits_rows(tmp_path):
    path = str(tmp_path / "m.safetensors")
    w = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    save_file({"model.layers.0.self_attn.qkv_proj.weight": w}, path,
              metadata={"format": "pt"})
    src = SafetensorsSource([path])
    assert src.keys() == ["model.layers.0.self_attn.qkv_proj.weight"]
    thirds = [src.collect("qkv_proj", splits=3, split_idx=i)[0]
              for i in range(3)]
    np.testing.assert_array_equal(np.concatenate(thirds), w.numpy())
    assert all(t.flags.c_contiguous for t in thirds)


@pytest.mark.parametrize("dtype,name", [(torch.int64, "I64"),
                                        (torch.float64, "F64"),
                                        (torch.int8, "I8")])
def test_reader_refuses_other_dtypes_by_name(tmp_path, dtype, name):
    path = str(tmp_path / "m.safetensors")
    save_file({"a": torch.zeros(4, dtype=torch.float32),
               "b": torch.zeros(4, dtype=dtype)}, path)
    f = SafetensorsFile(path)
    assert f.get("a").dtype == np.float32
    with pytest.raises(ValueError, match=name):
        f.get("b")


@pytest.mark.parametrize("family", ["GEMMA", "LLAMA", "PHI"])
def test_exported_model_logits_match_jax(tmp_path, family):
    """The port's f32 export loaded by the port, teacher-forced on 12
    tokens, against the JAX export run by the JAX engine on its serving
    path (matmul_impl "fast")."""
    cfg = family_config(family)
    files, cj, _ = write_checkpoint(tmp_path, cfg, family)
    export_main(["--files", *files, "--config", cj, "--save-path",
                 str(tmp_path / "port"), "--type", family])
    jax_export(files, cj, str(tmp_path / "jax"), family)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, 12)

    jf = jax_read_lmrs(str(tmp_path / "jax.lmrs"))
    eng = JaxEngine(jf.cfg.replace(matmul_impl="fast"),
                    jax_params_from_lmrs(jf),
                    cache_dtype=jnp.float32, min_attn_bucket=32,
                    prefill_chunk=16)
    want = np.asarray(eng.prefill(toks.tolist()))

    f = read_lmrs(str(tmp_path / "port.lmrs"))
    params = params_from_lmrs(f, device="cpu")
    cache = init_kv_cache(f.cfg, "cpu", torch.float32)
    x = embed_tokens(params, f.cfg, torch.from_numpy(toks))
    got = forward(params, f.cfg, cache, x, 0, len(toks) - 1).numpy()
    scale = np.abs(want).max()
    assert scale > 0.1
    assert np.abs(got - want).max() <= 1e-5 * scale


def test_chip_smoke_writer_reads_back_with_safe_open(tmp_path):
    """chip_smoke.py writes its checkpoint with a writer of its own (the
    card's machine has no `safetensors`): `safe_open` reads it bit for
    bit, and so does the port's reader."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    rng = np.random.default_rng(9)
    want = {"model.layers.1.mlp.up_proj.weight":
            torch.from_numpy(rng.normal(0, 1, (6, 10)).astype(np.float32))
            .to(torch.bfloat16),
            "model.embed_tokens.weight":
            torch.from_numpy(rng.normal(0, 1, (7, 3)).astype(np.float32))
            .to(torch.float16),
            "model.norm.weight":
            torch.from_numpy(rng.normal(0, 1, (5,)).astype(np.float32))}
    names = {torch.bfloat16: "BF16", torch.float16: "F16",
             torch.float32: "F32"}
    path = tmp_path / "w.safetensors"
    chip_smoke.write_safetensors(path, [
        (k, names[t.dtype], tuple(t.shape),
         lambda t=t: t.view(torch.int16 if t.element_size() == 2
                            else torch.int32).numpy().tobytes())
        for k, t in want.items()])
    with safe_open(str(path), framework="pt") as h:
        assert sorted(h.keys()) == sorted(want)
        for k, t in want.items():
            assert torch.equal(h.get_tensor(k), t)
    mine = SafetensorsFile(str(path))
    for k, t in want.items():
        np.testing.assert_array_equal(mine.get(k), t.float().numpy())
