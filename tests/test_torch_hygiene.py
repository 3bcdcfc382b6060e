"""lmrs_tpu_torch and chip_smoke.py import neither JAX nor the JAX package
lmrs_tpu, so they run on a machine that has neither; nor, until a caller
decodes an image file or serves a socket, PIL or websockets, which the
card's machine lacks."""

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
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
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
