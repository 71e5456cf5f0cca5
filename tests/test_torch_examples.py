"""The port's example programs against the JAX package's, on the CPU.

Each case runs the JAX package's ``examples/<name>.py`` (JAX on the CPU,
through the conftest's 8-device virtual mesh) and
``csgn_tpu_torch.examples.<name>`` with ``device="cpu"``, at the parameters
of tests/test_examples.py, and requires the two returned dicts to be equal on
every key but the host timings (``build_s``, ``eval_s``, ``decrypt_s``): the
port draws its keys, votes and bids from ``rng.key(seed)`` as the JAX
examples draw them from ``jax.random.key(seed)``, so the values a draw sets
are the same too; the examples assert their own decrypts as well.
Tolerance: exact.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _jax_example(name: str):
    """The JAX package's examples/<name>.py, imported under a private name."""
    spec = importlib.util.spec_from_file_location(f"_jax_example_{name}",
                                                  REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_example(name: str):
    return importlib.import_module(f"csgn_tpu_torch.examples.{name}")


# Host wall times, the only keys that differ between two runs.
TIMINGS = {"build_s", "eval_s", "decrypt_s"}

# name: arguments (both packages)
CASES = {
    "voting": dict(voters=16, n=95, d=4),
    "deep_chain_12": dict(depth=12, recrypt_at=256),
    "deep_chain_32": dict(depth=32, recrypt_at=1024),
    "key_rotation": dict(fleet=6, n=95, d=4),
    "bristol_adder": dict(x=2**63 + 12345, y=2**63 + 99999),
    "netlist_service": dict(bidders=6, width=8, n=95, d=4),
    "encrypted_aes": dict(n=95, d=4),
    "encrypted_hmac": dict(n=95, d=4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_example_returns_the_jax_examples_values(case):
    kw = CASES[case]
    name = case.rsplit("_", 1)[0] if case.startswith("deep_chain") else case
    got = _port_example(name).main(**kw, device="cpu")
    want = _jax_example(name).main(**kw)
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in TIMINGS} == \
        {k: v for k, v in want.items() if k not in TIMINGS}


_RANK = """
import json, sys
import torch
from csgn_tpu_torch import parallel
from csgn_tpu_torch.examples import sharded_pipeline
parallel.initialize(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), device="cpu")
print(json.dumps(sharded_pipeline.main(batch=16, n=95, d=4, device="cpu")), flush=True)
torch.distributed.destroy_process_group()
"""


def _gloo_job(world: int, tmp: pathlib.Path) -> list[dict]:
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, f"file://{tmp}/store", str(world),
                               str(r)], env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


@pytest.mark.parametrize("world", [1, 2])
def test_sharded_pipeline_over_a_gloo_job(world, tmp_path):
    """Every rank of a gloo job of `world` CPU processes returns the same
    dict; every key equals the JAX example's on its 8-device virtual mesh
    but the rank count, ``devices`` (the mesh-invariant encrypt makes the
    words independent of it)."""
    outs = _gloo_job(world, tmp_path)
    assert all(o == outs[0] for o in outs)
    want = _jax_example("sharded_pipeline").main(batch=16, n=95, d=4)
    got = outs[0]
    assert got["devices"] == world and want["devices"] == 8
    assert {k: v for k, v in got.items() if k != "devices"} == \
        {k: v for k, v in want.items() if k != "devices"}
    assert got["product_chunks"] == got["batch"] ** 2


def test_sharded_pipeline_makes_its_own_job_of_one_rank():
    """With no process group, the example runs as a job of one rank and
    leaves none behind."""
    import torch.distributed as dist

    out = _port_example("sharded_pipeline").main(batch=6, n=95, d=4, device="cpu")
    assert out == {"devices": 1, "batch": 6, "product_chunks": 36, "parity": 1}
    assert not dist.is_initialized()
