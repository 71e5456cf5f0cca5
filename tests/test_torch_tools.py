"""The port's tools on the CPU: the validate sweep at its small shapes, the
serving demo's bit equality, and the multi-process tools as gloo jobs of
CPU processes (the multihost demo, the fault demo with both checkpoint
forms, the scaling report at 1 and 2 ranks).

Each multi-process case runs the tool as ``python -m ...`` with a time limit
of its own (the fault demo's survivors may hang in a collective whose peer
was killed; the tool reaps them, and the test never waits without a limit).
Tolerance: exact.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from csgn_tpu_torch.ops import kernels
from csgn_tpu_torch.tools import serve_demo, validate

REPO = pathlib.Path(__file__).resolve().parent.parent
LIMIT_S = 120


def _tool(name: str, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", f"csgn_tpu_torch.tools.{name}", *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=LIMIT_S)


def test_validate_small_sweep_finds_no_failure(capsys):
    assert validate.main(small=True, device="cpu") == 0
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1] == "FAILS: none"
    assert "mode=unaligned" in out and "mode=aligned" in out
    assert out.count("exact=True") == 29 and "exact=False" not in out


def test_validate_reports_a_wrong_product(monkeypatch, capsys):
    """A multiply that differs from its plain version in one word fails the
    cases that run it."""
    right = kernels.mul_chunks

    def wrong(a, b):
        out = right(a, b).clone()
        out[0, -1] ^= 1
        return out

    monkeypatch.setattr(kernels, "mul_chunks", wrong)
    sweep = validate.Sweep(validate.resolve_device("cpu"))
    sweep.mul([(3, 5)])
    sweep.auto([(2, 2)])
    assert sweep.fails == ["mul 3x5 mode=unaligned", "mul auto 2x2 mode=aligned"]
    assert "exact=False" in capsys.readouterr().out


def test_serve_demo_batched_bits_equal_per_request():
    out = serve_demo.main(device="cpu")
    # Request i multiplies two 2-chunk ciphertexts of parity 1 ^ (i % 2).
    assert out["bits"] == [1 - i % 2 for i in range(serve_demo.REQUESTS)]
    assert len(out["trials"]) == serve_demo.TRIALS and out["device"] == "cpu"


def test_multihost_demo_two_gloo_ranks():
    res = _tool("multihost_demo", "--nproc", "2", "--device", "cpu")
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "multihost demo: OK" in res.stdout
    for r in range(2):
        assert f"[rank {r}] 2 ranks on cpu: words_exact=True" in res.stdout


@pytest.mark.parametrize("nproc,sharded", [(2, False), (2, True)])
def test_rank_loss_mid_step_then_resume(nproc, sharded):
    """The last of `nproc` gloo ranks is killed mid-step; a one-rank job on
    the CPU resumes from the last checkpoint (rank 0's npz, or per-rank
    blocks) and finishes bit-equal to the unsharded oracle."""
    res = _tool("fault_demo", "--nproc", str(nproc), "--device", "cpu",
                *(["--sharded-ckpt"] if sharded else []))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "fault demo: OK" in res.stdout
    assert f"killed worker {nproc - 1} of {nproc}" in res.stdout
    assert "resumed from step 1 on 1 rank (cpu): words_exact=True" in res.stdout


def test_scaling_bench_one_and_two_gloo_ranks():
    res = _tool("scaling_bench", "--device", "cpu", "--nproc", "2", "--chunks", "64",
                "--t2", "16")
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    lines = [json.loads(x) for x in res.stdout.strip().splitlines()]
    rows, summary = lines[:-1], lines[-1]
    assert [r["devices"] for r in rows] == [1, 2] and summary["rows"] == rows
    for r in rows:
        assert r["device"] == "cpu" and r["ms"] > 0
        assert r["Mchunks_per_s"] == pytest.approx(64 * 16 / r["ms"] / 1e3)
