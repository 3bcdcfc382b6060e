"""lmrs_tpu_torch, chip_smoke.py and scripts/torch_*.py import neither JAX
nor the JAX package lmrs_tpu, so they run on a machine that has neither;
nor, until a caller decodes an image file or serves a socket, PIL or
websockets, which the card's machine lacks; nor safetensors or
transformers, which it lacks too (the tokenizer exporters alone import
transformers, when called)."""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "lmrs_tpu_torch"
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+lmrs_tpu\b(?!_)"
    r"|from\s+lmrs_tpu(\.|\s)(?!_))", re.M)


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_loads_no_jax():
    mods = list(_modules())
    assert "lmrs_tpu_torch.kernels.q4_gemv" in mods
    assert {"lmrs_tpu_torch.serve.scheduler",
            "lmrs_tpu_torch.serve.backend"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'lmrs_tpu' or "
            "m.startswith('lmrs_tpu.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO),
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_source_imports_jax_or_the_jax_package():
    files = (sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "scripts").glob("torch_*.py")))
    assert REPO / "scripts" / "torch_perplexity.py" in files
    assert (REPO / "chip_smoke.py").exists()
    offenders = [str(p.relative_to(REPO)) for p in files
                 if _FORBIDDEN.search(p.read_text())]
    assert offenders == []
    # the pattern does catch the forms it must catch
    for line in ("import jax", "from jax import numpy",
                 "import lmrs_tpu.quant", "from lmrs_tpu.io import lmrs",
                 "from lmrs_tpu import config"):
        assert _FORBIDDEN.search(line), line
    assert not _FORBIDDEN.search("from lmrs_tpu_torch.io import lmrs")


def test_importing_every_module_loads_no_pil_or_websockets():
    """PIL is imported only to decode an image file
    (`models.phi3v.load_image`), websockets only by
    `BackendServer.serve`; the multimodal path from an array runs without
    either."""
    mods = list(_modules())
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import numpy as np, torch\n"
            "from lmrs_tpu_torch.models.phi3v import preprocess_image\n"
            "img = np.zeros((90, 120, 3), np.uint8)\n"
            "assert preprocess_image(img, 4)[0].shape == (5, 576, 588)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('PIL', 'websockets')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO),
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


_THIRD_PARTY = re.compile(
    r"^\s*(import|from)\s+(safetensors|transformers)\b", re.M)


def test_no_package_source_imports_safetensors_or_transformers():
    """Not even lazily: the checkpoint reader is the package's own
    (`io.safetensors`); only the tokenizer exporters, which cannot work
    without it, import transformers."""
    allowed = {PKG / "io" / "tokenizer_export.py"}
    offenders = [str(p.relative_to(REPO)) for p in sorted(PKG.rglob("*.py"))
                 if p not in allowed and _THIRD_PARTY.search(p.read_text())]
    assert offenders == []
    assert _THIRD_PARTY.search("    from transformers import AutoTokenizer")
    assert not _THIRD_PARTY.search(
        "from lmrs_tpu_torch.io.safetensors import SafetensorsSource")


def test_the_offline_path_loads_no_jax_safetensors_transformers_or_pil(
        tmp_path):
    """Importing every module and scripts/torch_perplexity.py, writing a
    checkpoint with chip_smoke's writer, exporting it, tokenizing with the
    native engine and scoring the export on the CPU loads none of jax,
    lmrs_tpu, safetensors, transformers, websockets or PIL."""
    mods = list(_modules())
    code = f"""
import importlib, json, sys
import numpy as np
for m in {mods!r}:
    importlib.import_module(m)
sys.path.insert(0, "scripts")
import chip_smoke, torch_perplexity
from lmrs_tpu_torch.config import QuantType, tiny_llama
from lmrs_tpu_torch.io.export import export
from lmrs_tpu_torch.io.lmrs import read_lmrs
from lmrs_tpu_torch.io.params import params_from_lmrs
from lmrs_tpu_torch.tokenizer import Tokenizer
cfg = tiny_llama()
rng = np.random.default_rng(0)
def bf16(shape, mean=0.0):
    w = (mean + rng.normal(0, 0.02, shape)).astype(np.float32)
    return lambda: (w.view(np.uint32) >> 16).astype(np.uint16).tobytes()
D, H, A, KV = cfg.dim, cfg.hidden_dim, cfg.att_dim, cfg.kv_dim
entries = [("model.embed_tokens.weight", "BF16", (cfg.vocab_size, D),
            bf16((cfg.vocab_size, D))),
           ("model.norm.weight", "BF16", (D,), bf16((D,), 1.0))]
for l in range(cfg.n_layers):
    p = f"model.layers.{{l}}."
    for n, s in (("input_layernorm", (D,)), ("post_attention_layernorm",
                 (D,)), ("self_attn.q_proj", (A, D)), ("self_attn.k_proj",
                 (KV, D)), ("self_attn.v_proj", (KV, D)),
                 ("self_attn.o_proj", (D, A)), ("mlp.gate_proj", (H, D)),
                 ("mlp.up_proj", (H, D)), ("mlp.down_proj", (D, H))):
        entries.append((p + n + ".weight", "BF16", s,
                        bf16(s, 1.0 if len(s) == 1 else 0.0)))
chip_smoke.write_safetensors("{tmp_path}/model.safetensors", entries)
json.dump(dict(hidden_size=D, intermediate_size=H,
               num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
               head_dim=cfg.head_dim, num_key_value_heads=cfg.n_kv_heads,
               vocab_size=cfg.vocab_size, max_position_embeddings=cfg.seq_len,
               rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta),
          open("{tmp_path}/config.json", "w"))
out = export(["{tmp_path}/model.safetensors"], "{tmp_path}/config.json",
             "{tmp_path}/m", "LLAMA", quantize=True, quantize_type=1,
             group_size=32)
f = read_lmrs(out)
chip_smoke.synthetic_tokenizer("{tmp_path}/tok.bin", cfg.vocab_size, True)
tok = Tokenizer.from_file("{tmp_path}/tok.bin")
assert tok._native is not None
ids = np.asarray(tok.encode("hello from the smoke run card " * 8))
r = torch_perplexity.score_tokens(f.cfg, params_from_lmrs(f, "cpu"), ids)
assert np.isfinite(r["nll_per_token"]) and r["tokens_scored"] == len(ids) - 1
print(sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "lmrs_tpu", "safetensors", "transformers",
              "websockets", "PIL")))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(REPO),
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_mesh_ranks_import_no_jax(tmp_path):
    """The spawned ranks of a mesh import no JAX either: with `jax` and
    `lmrs_tpu` packages on the path that fail when imported (the spawned
    processes inherit the path), a tp = 2 mesh starts on the CPU,
    generates and stops."""
    for name in ("jax", "lmrs_tpu"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('{name} imported by a mesh rank')\n")
    code = (
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from lmrs_tpu_torch.config import tiny_llama, QuantType\n"
        "from lmrs_tpu_torch.io.lmrs import write_lmrs\n"
        "from lmrs_tpu_torch.io.synthetic import random_weights\n"
        "from lmrs_tpu_torch.parallel.tp import make_mesh_engine\n"
        "from lmrs_tpu_torch.runtime.engine import GenerationConfig\n"
        "cfg = tiny_llama(quant=QuantType.Q8_0)\n"
        f"path = {str(tmp_path / 'm.lmrs')!r}\n"
        "write_lmrs(path, cfg, random_weights(cfg, 0))\n"
        "eng = make_mesh_engine(path, tp=2, device='cpu')\n"
        "print(eng.generate([1, 2, 3], GenerationConfig(temperature=0.0, "
        "max_new_tokens=3)))\n"
        "eng.mesh.shutdown()\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(tmp_path),
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                             [str(tmp_path), str(REPO)])))
    assert out.returncode == 0, out.stderr
    assert "imported by a mesh rank" not in out.stderr
    assert "mesh: tp=2 cp=1" in out.stdout
    assert out.stdout.strip().splitlines()[-1].startswith("[")
