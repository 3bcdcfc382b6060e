"""On the card: one short run of each cell, as BENCHMARK.json's command
runs it, comes out correct and reports its metrics.  Skips without a CUDA
device (decided in a fixture).  On the card:
python -m pytest portbench/tests -m gpu"""

import json
import subprocess
import sys

import pytest

from portbench.tests import tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [
    "phi35-mini-q4.docqa-shared", "phi35-mini-q4.chat-sessions"])
def test_cell_runs_correct(card, workload):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", str(2**31 + 77), "--seconds", "20", "--trace", "0"],
        capture_output=True, text=True, timeout=360, cwd=str(tiny.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu"
    assert "setup_s" in res["metrics"] and "output_tok_s" in res["metrics"]
