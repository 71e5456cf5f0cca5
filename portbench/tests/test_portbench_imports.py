"""No module of the benchmark imports JAX or the JAX package, by whole
top-level names (the port's name begins with the JAX package's), and the
reference imports nothing of the program; a run loads neither."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "csgn_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(PKG)) for p in SOURCES])
def test_no_jax_import(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_the_runs_check_compares_whole_top_level_names(monkeypatch):
    import types

    from portbench import harness

    for name in ("csgn_tpu_torch.fake", "jaxlike", "csgn_tpux"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "csgn_tpu.fake", types.ModuleType("csgn_tpu.fake"))
    monkeypatch.setitem(sys.modules, "jax.fake", types.ModuleType("jax.fake"))
    assert harness.forbidden_modules() == ["csgn_tpu", "jax"]


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert set(_imports(path)) <= {"__future__", "numpy", "torch"}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import json, torch; torch.set_num_threads(1)\n"
        "from portbench import harness\n"
        "out, _ = harness.run_cell('muldec-bulk-4096', 5, 0.2, False, device='cpu',"
        " traffic={'shapes': [[8, 8]], 'sets': 1})\n"
        "print(json.dumps([out['correct'], harness.forbidden_modules()]))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(PKG.parent), "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    assert json.loads(res.stdout.strip().splitlines()[-1]) == [True, []]


def test_without_a_card_the_run_exits_with_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    env = {**os.environ, "PYTHONPATH": str(PKG.parent)}
    res = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "muldec-bulk-4096", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=PKG.parent, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 2 and res.stdout == ""
