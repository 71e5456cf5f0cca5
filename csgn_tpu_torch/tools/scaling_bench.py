"""Scaling report: the sharded fused multiply+decrypt rate at each world size.

The port of the JAX package's tools/scaling_bench.py.  At each world size it
times `parallel.sharded_mul_decrypt` of a ``[W, chunks] x [W, t2]`` product
at Context(1247, 16), chunk-sharded over the job's ranks (the all-gather of
b, the fused K2 on each rank's block, one int64 all-reduce of the count),
host wall around each call with the parity read back, median of five
calls after one untimed call, and prints one JSON line a row: world size,
the device, ms, product chunks per second and per rank.

  * On the card (the default) it runs in-process over NCCL, in the job the
    caller has joined or else a job of one rank.  The machine it was written
    for has one H100, so it gives the world-size-1 row and says that rows
    for more ranks need a job of that many cards; it prints no row it did
    not measure.
  * With ``--device cpu`` it starts gloo jobs of 1, 2, 4, ... up to
    ``--nproc`` CPU processes, one row each (CPU-speed numbers: the shape
    of the layer's overhead, not a device rate).

Run: python -m csgn_tpu_torch.tools.scaling_bench [--nproc 4] [--chunks 4096] [--t2 256]
                                                   [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from csgn_tpu_torch import Context, SecretKey, parallel
from csgn_tpu_torch._device import resolve_device
from csgn_tpu_torch.layout import words_from_numpy
from csgn_tpu_torch.rng import key as rng_key
from csgn_tpu_torch.tools._jobs import job, start_ranks, wait_ranks

MODULE = "csgn_tpu_torch.tools.scaling_bench"
TIMEOUT_S = 600
REPS = 5


def measure(dev: torch.device, chunks: int, t2: int) -> dict:
    """Every rank of the job calls this; it returns the job's row."""
    mesh = parallel.global_chunk_mesh()
    nd, me = mesh.shape["c"], mesh.coord("c")
    if chunks % nd or t2 % nd:
        raise ValueError(f"chunks {chunks} and t2 {t2} must be multiples of {nd} ranks")
    ctx = Context(1247, 16)
    rng = np.random.default_rng(0)                 # the same on every rank
    vm = ctx.valid_mask[:, None]
    a = rng.integers(0, 2**32, (ctx.words32, chunks), dtype=np.uint32) & vm
    b = rng.integers(0, 2**32, (ctx.words32, t2), dtype=np.uint32) & vm
    ca, cb = chunks // nd, t2 // nd
    a_blk = words_from_numpy(np.ascontiguousarray(a[:, me * ca:(me + 1) * ca]), dev)
    b_blk = words_from_numpy(np.ascontiguousarray(b[:, me * cb:(me + 1) * cb]), dev)
    sk = SecretKey.generate(ctx, rng_key(0), dev)   # the JAX tool's jax.random.key(0)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    barrier_on = {"device_ids": [dev.index]} if dev.type == "cuda" else {}

    def step() -> float:
        dist.barrier(group=mesh.group_all, **barrier_on)
        sync()
        t0 = time.perf_counter()
        _, parity = parallel.sharded_mul_decrypt(a_blk, b_blk, sk.mask_words, mesh)
        int(parity)                                # the parity on the host: the call is done
        return time.perf_counter() - t0

    step()
    t = statistics.median(step() for _ in range(REPS))
    out_chunks = chunks * t2
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"devices": nd, "device": name, "chunks": chunks, "t2": t2, "ms": t * 1e3,
            "Mchunks_per_s": out_chunks / t / 1e6, "per_device": out_chunks / t / 1e6 / nd}


def worker(rank: int, store: str, nproc: int, chunks: int, t2: int, out: str) -> int:
    parallel.initialize(f"file://{store}", nproc, rank, device="cpu")
    try:
        row = measure(torch.device("cpu"), chunks, t2)
        if rank == 0:
            pathlib.Path(out).write_text(json.dumps(row))
    finally:
        dist.destroy_process_group()
    return 0


def _summary(rows: list[dict], **extra) -> dict:
    eff = rows[-1]["per_device"] / rows[0]["per_device"]
    return {"rows": rows, "weak_scaling_efficiency": eff, **extra}


def run(nproc: int = 1, chunks: int = 4096, t2: int = 256, device=None) -> dict:
    """The report: one row per world size, printed as it comes."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        with job(device) as dev:
            row = measure(dev, chunks, t2)
            world = dist.get_world_size()
        print(json.dumps(row))
        note = (f"one process on {torch.cuda.device_count()} CUDA device(s): world size "
                f"{world} measured; a row for N ranks needs a job of N cards, one rank each")
        print(note)
        return _summary([row], note=note)
    rows = []
    world = 1
    while world <= nproc:
        with tempfile.TemporaryDirectory(prefix="scaling_bench_") as tmp:
            out = pathlib.Path(tmp) / "row.json"
            procs = start_ranks(MODULE, world, f"{tmp}/store",
                                ["--chunks", str(chunks), "--t2", str(t2), "--out", str(out)])
            rcs = wait_ranks(procs, TIMEOUT_S)
            if max(rcs):
                raise RuntimeError(f"the job of {world} ranks failed: exit codes {rcs}")
            rows.append(json.loads(out.read_text()))
        print(json.dumps(rows[-1]))
        world *= 2
    return _summary(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=4, help="largest world size (--device cpu)")
    ap.add_argument("--chunks", type=int, default=4096)
    ap.add_argument("--t2", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="cpu: gloo jobs on the CPU (default: the current CUDA device)")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        return worker(args.worker, args.store, args.nproc, args.chunks, args.t2, args.out)
    print(json.dumps(run(args.nproc, args.chunks, args.t2, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
