"""Jobs of ranks for the port's programs (`csgn_tpu_torch.examples`, `tools`).

  * `job(device)` — the process group a program runs in: the one the caller
    already joined (under ``torchrun``, or in a test's job), or else
    a job of one rank over a ``file://`` store in a temporary directory,
    NCCL on a CUDA device and gloo on the CPU (`parallel.initialize`), which
    is destroyed on exit.
  * `start_ranks` / `wait_ranks` — a driver's side of a job of several
    processes: ``python -m <module> --worker RANK --store STORE --nproc N``,
    one process per rank, rendezvous at a ``file://`` store under a
    temporary directory (no port to collide on), waited for with a time
    limit after which every rank still running is killed.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from csgn_tpu_torch.parallel.multihost import initialize

__all__ = ["job", "child_env", "start_ranks", "wait_ranks", "reap"]

ROOT = pathlib.Path(__file__).resolve().parents[2]   # the checkout holding csgn_tpu_torch/


@contextlib.contextmanager
def job(device=None):
    """Yield this rank's device inside a process group: the existing one, or
    a new one-rank job on `device` (None: the current CUDA device over NCCL,
    raising where there is none; ``"cpu"``: gloo), destroyed on exit."""
    if dist.is_initialized():
        here = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend() == "nccl" else torch.device("cpu")
        if device is not None and torch.device(device).type != here.type:
            raise ValueError(f"the job's ranks hold {here}, not {device}")
        yield here
        return
    with tempfile.TemporaryDirectory(prefix="csgn_job_") as tmp:
        dev = initialize(f"file://{tmp}/store", 1, 0, device=device)
        try:
            yield dev
        finally:
            dist.destroy_process_group()


def child_env() -> dict:
    """The environment of a child process: this checkout first on the path,
    one OpenMP thread (the ranks share the host's cores)."""
    path = os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p)
    return dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")


def start_ranks(module: str, nproc: int, store: str, args: list[str]) -> list[subprocess.Popen]:
    """Start ``python -m module --worker r --store STORE --nproc N *args`` for
    every rank r, in `child_env`."""
    return [subprocess.Popen([sys.executable, "-m", module, "--worker", str(r), "--store", store,
                              "--nproc", str(nproc), *args], env=child_env())
            for r in range(nproc)]


def reap(procs: list[subprocess.Popen]) -> None:
    """Kill every rank still running and wait for all of them."""
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait(timeout=60)


def wait_ranks(procs: list[subprocess.Popen], timeout: float) -> list[int]:
    """The ranks' exit codes; past `timeout` seconds every rank still
    running is killed and TimeoutError raised."""
    deadline = time.monotonic() + timeout
    try:
        return [p.wait(timeout=max(deadline - time.monotonic(), 0.01)) for p in procs]
    except subprocess.TimeoutExpired as e:
        raise TimeoutError(f"ranks still running after {timeout} s: {e.cmd}") from None
    finally:
        reap(procs)
