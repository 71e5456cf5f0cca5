"""Each cell briefly on the card, at its own sizes: the program comes out
correct and the control does not.  Needs an NVIDIA GPU; run there with
``python3 -m pytest -q portbench/tests/test_portbench_cuda.py``."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from portbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _python(*args, timeout=600):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=timeout, check=False)
    assert res.returncode == 0, res.stderr[-4000:]
    return [json.loads(line) for line in res.stdout.strip().splitlines()]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(cell, trace):
    _card()
    out = _python("portbench.run", "--workload", cell, "--seed", "2147483659", "--seconds", "3",
                  "--trace", str(trace))[-1]
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    names = {m["name"] for m in harness.cell_metrics(harness.manifest(), cell, bool(trace))}
    assert set(out["metrics"]) <= names and list(out)[-1] == "checks"
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    else:
        assert set(out["metrics"]) == names


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_the_cells_size(cell):
    _card()
    rows = _python("portbench.control", "--workload", cell, "--seconds", "2", "--seeds",
                   "3000000001", "3000000002", "3000000003")
    assert len(rows) == 3 and not any(r["correct"] for r in rows), rows
