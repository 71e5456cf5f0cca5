"""The port's example programs against the JAX package's, on the CPU.

Each case runs the JAX package's ``examples/<name>.py`` (JAX on the CPU,
through the conftest's 8-device virtual mesh) and
``csgn_tpu_torch.examples.<name>`` with ``device="cpu"``, at the parameters
of tests/test_examples.py, and requires the two returned dicts to be equal on
every key that no random draw sets.  Keys and encryption randomness cannot be
matched between the packages (their generators differ), so the keys a draw
sets (the votes, the bids) are held to their plaintext expectations instead;
the examples assert their own decrypts as well.  Tolerance: exact.
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


def _check_voting(out, kw):
    assert out["voters"] == kw["voters"]
    assert out["parity"] == out["yes_votes"] % 2
    assert out["unanimous"] == int(out["yes_votes"] == out["voters"])


def _check_netlist_service(out, kw):
    from csgn_tpu_torch.examples.netlist_service import auction

    bids, reserve = auction(kw["bidders"], kw["width"], kw.get("seed", 0))
    assert out["reserve"] == reserve
    assert out["qualified"] == [int(b > reserve) for b in bids]


def _check_aes(out, kw):
    assert out["ciphertext"] == "69c4e0d86a7b0430d8cdb78070b4c55a"    # FIPS-197 C.1
    assert out["ands"] == 51_200


def _check_hmac(out, kw):
    import hmac

    assert out["tag"] == hmac.new(bytes(range(32)), b"attested by csgn_tpu", "sha256").hexdigest()


# name: arguments (both packages), draw-independent keys, the check of the
# port's other keys against their plaintext expectations
CASES = {
    "voting": (dict(voters=16, n=95, d=4), ["voters"], _check_voting),
    "deep_chain_12": (dict(depth=12, recrypt_at=256),
                      ["depth", "final_chunks", "peak_chunks", "recrypts",
                       "unbounded_chunks_would_be", "decrypted"], None),
    "deep_chain_32": (dict(depth=32, recrypt_at=1024),
                      ["depth", "final_chunks", "peak_chunks", "recrypts",
                       "unbounded_chunks_would_be", "decrypted"], None),
    "key_rotation": (dict(fleet=6, n=95, d=4), ["fleet", "decrypted", "expected"], None),
    "bristol_adder": (dict(x=2**63 + 12345, y=2**63 + 99999),
                      ["x", "y", "sum", "gates", "and_gates", "materialized_growth_max",
                       "decrypted_bits_checked"], None),
    "netlist_service": (dict(bidders=6, width=8, n=95, d=4),
                        ["bidders", "encrypt_dispatches", "and_gates"], _check_netlist_service),
    "encrypted_aes": (dict(n=95, d=4), ["ciphertext", "gates", "ands"], _check_aes),
    "encrypted_hmac": (dict(n=95, d=4), ["tag", "compressions"], _check_hmac),
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_example_returns_the_jax_examples_values(case):
    kw, same, check = CASES[case]
    name = case.rsplit("_", 1)[0] if case.startswith("deep_chain") else case
    got = _port_example(name).main(**kw, device="cpu")
    want = _jax_example(name).main(**kw)
    assert set(got) == set(want)
    assert {k: got[k] for k in same} == {k: want[k] for k in same}
    if check is not None:
        check(got, kw)


_RANK = """
import json, sys
from csgn_tpu_torch import parallel
from csgn_tpu_torch.examples import sharded_pipeline
parallel.initialize(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), device="cpu")
print(json.dumps(sharded_pipeline.main(batch=16, n=95, d=4, device="cpu")))
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
    dict; its draw-independent keys equal the JAX example's on its 8-device
    virtual mesh (the rank count differs: ``devices``)."""
    outs = _gloo_job(world, tmp_path)
    assert all(o == outs[0] for o in outs)
    want = _jax_example("sharded_pipeline").main(batch=16, n=95, d=4)
    got = outs[0]
    assert got["devices"] == world and want["devices"] == 8
    same = ["batch", "product_chunks", "parity"]
    assert {k: got[k] for k in same} == {k: want[k] for k in same}
    assert got["product_chunks"] == got["batch"] ** 2


def test_sharded_pipeline_makes_its_own_job_of_one_rank():
    """With no process group, the example runs as a job of one rank and
    leaves none behind."""
    import torch.distributed as dist

    out = _port_example("sharded_pipeline").main(batch=6, n=95, d=4, device="cpu")
    assert out == {"devices": 1, "batch": 6, "product_chunks": 36, "parity": 1}
    assert not dist.is_initialized()
