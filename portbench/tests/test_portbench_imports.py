"""Nothing the benchmark runs imports the JAX package or JAX (top-level
module names compared whole: `lmrs_tpu_torch` is not `lmrs_tpu`), and the
plain reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import torch

from portbench.run import FORBIDDEN, forbidden_modules

torch.set_num_threads(1)
HERE = Path(__file__).resolve().parents[1]


def imported(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_top_level_names_compared_whole():
    assert "lmrs_tpu_torch" not in FORBIDDEN
    assert "lmrs_tpu" in FORBIDDEN and "jax" in FORBIDDEN
    assert "jaxlib" in FORBIDDEN


def test_no_file_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        bad = imported(path) & set(FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_port():
    for path in (HERE / "reference").rglob("*.py"):
        names = imported(path)
        assert "lmrs_tpu_torch" not in names, path
        # nor a module of the harness that would bring the port in
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("portbench"):
                assert node.module.startswith("portbench.reference"), path


def test_a_run_loads_no_jax():
    """A whole CPU run in a fresh process, then the run's own check."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.tests import tiny\n"
        "from portbench.run import run_cell, forbidden_modules\n"
        "c = tiny.cell('phi35-mini-q4.docqa-shared', tiny.tiny_conf(), "
        "tiny.tiny_docqa())\n"
        "r = run_cell(c, 3, 1.0, False, 'cpu')\n"
        "print('FORBIDDEN', forbidden_modules())\n") % str(HERE.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(HERE.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout
    assert isinstance(forbidden_modules(), list)


def test_a_module_loaded_after_the_window_stops_the_result(monkeypatch,
                                                            capsys):
    """The look at `sys.modules` comes after the output check: a module
    that the reference or a reader loads late still stops the result."""
    import types

    from portbench import run as R

    def run_cell(*a, **kw):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return {"_info": {}, "_checks": {}, "correct": True}

    monkeypatch.setattr(R, "run_cell", run_cell)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.chdir(HERE.parent)
    rc = R.main(["--workload", "phi35-mini-q4.docqa-shared", "--seed", "1",
                 "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == ""
    assert "jax" in err
