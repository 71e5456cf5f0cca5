"""Fault injection for elastic recovery: a rank dies mid-step, and the chain
resumes from its last checkpoint in a different job.

The port of the JAX package's tools/fault_demo.py, with its constants.

Phase 1: a job of ``--nproc`` ranks (default 2), CPU processes over gloo,
runs a multiply chain of N_STEPS steps at Context(1247, 16) with the
accumulator chunk-sharded over the ranks (`sharded_mul_broadcast`),
checkpointing it after every completed step: gathered to rank 0, which
writes one ``.npz`` (`save_state`), or with ``--sharded-ckpt`` one block a
rank (`save_state_sharded` on the mesh, no gather).  While step FAULT_STEP
is in flight, the driver SIGKILLs the last rank (the exact child process, a
real host loss mid-step); the survivors, stuck in the step's now
unanswerable collective or failing in it, are torn down by the driver, like
a job scheduler reaping a degraded job.

Phase 2: a fresh single process (a different world: one rank) on
``--device`` — the current CUDA device unless ``--device cpu`` — loads the
last checkpoint onto its one-rank mesh (``load_state_sharded(dir,
mesh=...)`` for the per-rank form), finishes the chain and decrypts.

The final product words and parity must be bit-equal to an unsharded
one-process oracle of the whole chain (the plain product on the CPU): the
checkpoint is the recovery unit, and the resume does not depend on the
mesh's shape.  The ranks of phase 1 run on the CPU because one card cannot
hold two NCCL ranks; the resume, which is what the demo proves, runs where
``--device`` says.

Determinism: the ranks meet at a ``file://`` store in the run's temporary
directory, so concurrent runs never collide; the doomed rank holds the fault
window open by waiting on a sentinel file the driver never writes — only
its SIGKILL (or a 300 s safety cap) ends the wait, so the window cannot
close early on a loaded host.

Run: python -m csgn_tpu_torch.tools.fault_demo [--nproc N] [--sharded-ckpt] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from csgn_tpu_torch import Ciphertext, Context, SecretKey, parallel
from csgn_tpu_torch import io as cio
from csgn_tpu_torch._device import resolve_device
from csgn_tpu_torch.layout import words_from_numpy
from csgn_tpu_torch.ops import kernels
from csgn_tpu_torch.parallel.ops import gather_chunks
from csgn_tpu_torch.tools._jobs import child_env, job, reap, start_ranks

MODULE = "csgn_tpu_torch.tools.fault_demo"
N_STEPS = 3          # multiply steps in the chain
FAULT_STEP = 2       # the last rank dies while this step is in flight
ACC_CHUNKS = 8       # the chain's first operand; chunks 8 -> 16 -> 32 -> 64
TIMEOUT_S = 300


def _inputs(device):
    """Deterministic chain inputs, identical in every process and phase
    (the JAX demo's: the same numpy draws, the same key indices)."""
    ctx = Context(1247, 16)
    rng = np.random.default_rng(7)
    vm = ctx.valid_mask[:, None]
    acc0 = rng.integers(0, 2**32, (ctx.words32, ACC_CHUNKS), dtype=np.uint32) & vm
    ops = [rng.integers(0, 2**32, (ctx.words32, 2), dtype=np.uint32) & vm
           for _ in range(N_STEPS)]
    sk = SecretKey(ctx, np.arange(ctx.d, dtype=np.int32) * 71 + 3, device)
    return ctx, acc0, ops, sk


def worker(rank: int, store: str, workdir: str, nproc: int, sharded_ckpt: bool) -> int:
    parallel.initialize(f"file://{store}", nproc, rank, device="cpu")
    wd = pathlib.Path(workdir)
    ctx, acc0, ops, sk = _inputs("cpu")
    mesh = parallel.chunk_mesh()
    acc = parallel.shard_ciphertext(Ciphertext(words_from_numpy(acc0, "cpu"), ctx), mesh).wt

    for step, op in enumerate(ops):
        if step == FAULT_STEP:
            # Mark the step in flight so the driver can kill the last rank
            # while its peers sit inside the step's collective.  The doomed
            # rank waits on a sentinel the driver never writes.
            (wd / f"inflight_{rank}").write_text(str(os.getpid()))
            if rank == nproc - 1:
                cap = time.time() + 300
                while not (wd / "release").exists() and time.time() < cap:
                    time.sleep(0.1)
        acc = parallel.sharded_mul_broadcast(acc, words_from_numpy(op, "cpu"), mesh)
        if sharded_ckpt:
            # Per-rank checkpoint: every rank writes ONLY its own blocks.
            cio.save_state_sharded(wd / f"ckpt_step{step}",
                                   {"acc": Ciphertext(acc, ctx), "sk": sk}, mesh)
            if rank == 0:
                (wd / f"done_step{step}").write_text("ok")
        else:
            # Gathered checkpoint: an all-gather, then rank 0 writes.
            full = gather_chunks(acc, mesh)
            if rank == 0:
                cio.save_state(wd / f"ckpt_step{step}.npz",
                               {"acc": Ciphertext(full, ctx), "sk": sk})
                (wd / f"done_step{step}").write_text("ok")
        dist.barrier()
    dist.destroy_process_group()
    return 0


def resume(workdir: str, sharded_ckpt: bool, device) -> int:
    """Phase 2: one rank on `device` finishes the chain from the last
    checkpoint."""
    wd = pathlib.Path(workdir)
    done = sorted(int(p.name.split("step")[1]) for p in wd.glob("done_step*"))
    if not done or done[-1] >= N_STEPS - 1:
        raise RuntimeError(f"completed steps {done}: the fault did not interrupt the chain")
    last = done[-1]
    _, acc0, ops, sk = _inputs("cpu")
    with job(device) as dev:
        mesh = parallel.chunk_mesh(1)
        if sharded_ckpt:
            # Re-lay the per-rank blocks onto the new (smaller) mesh: each
            # rank reads only the columns of its own block.
            state = cio.load_state_sharded(wd / f"ckpt_step{last}", mesh=mesh)
            acc = state["acc"].wt
        else:
            state = cio.load_state(wd / f"ckpt_step{last}.npz", device=dev)
            acc = parallel.shard_ciphertext(state["acc"], mesh).wt
        for op in ops[last + 1:]:
            acc = parallel.sharded_mul_broadcast(acc, words_from_numpy(op, dev), mesh)
        parity = int(parallel.sharded_decrypt_parity(acc, state["sk"].mask_words, mesh))
        got = acc.cpu()

    # Unsharded oracle of the WHOLE chain (no checkpoint, no fault), on the CPU.
    want = words_from_numpy(acc0, "cpu")
    for op in ops:
        want = kernels.mul_chunks_plain(want, words_from_numpy(op, "cpu"))
    want_parity = int(kernels.decrypt_parity_plain(want, sk.mask_words))
    ok_words = torch.equal(got, want)
    ok = ok_words and parity == want_parity
    print(f"resumed from step {last} on 1 rank ({dev}): words_exact={ok_words} "
          f"parity={parity} want={want_parity} -> {'OK' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


def _fault(nproc: int, wd: pathlib.Path, extra: list[str]) -> str | None:
    """Phase 1: run the job and kill its last rank mid-step; the reason it
    failed, or None."""
    victim = nproc - 1
    procs = start_ranks(MODULE, nproc, str(wd / "store"), ["--workdir", str(wd), *extra])
    try:
        # Wait until every rank has reached the fault step (the survivors
        # then wedge inside the step's collective, whose last participant
        # is parked on the sentinel wait).
        deadline = time.monotonic() + TIMEOUT_S
        while not all((wd / f"inflight_{i}").exists() for i in range(nproc)):
            if any(p.poll() is not None for p in procs):
                return "a rank died before the fault step"
            if time.monotonic() > deadline:
                return "the ranks never reached the fault step"
            time.sleep(0.2)
        time.sleep(0.5)  # let the survivors sink into the collective
        procs[victim].send_signal(signal.SIGKILL)  # the injected host loss
        procs[victim].wait(timeout=30)
        print(f"killed worker {victim} of {nproc} (pid {procs[victim].pid}) "
              f"mid-step {FAULT_STEP}", flush=True)
        time.sleep(1.0)  # then reap the survivors, as a scheduler would
    finally:
        reap(procs)
    if not (wd / f"done_step{FAULT_STEP - 1}").exists():
        return "no pre-fault checkpoint"
    if (wd / f"done_step{FAULT_STEP}").exists():
        return "the fault step completed anyway"
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--sharded-ckpt", action="store_true",
                    help="per-rank checkpoints (save_state_sharded) instead of rank 0's "
                         "gathered npz")
    ap.add_argument("--device", default=None,
                    help="the resume's torch device (default: the current CUDA device)")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--resume", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        return worker(args.worker, args.store, args.workdir, args.nproc, args.sharded_ckpt)
    if args.resume:
        return resume(args.workdir, args.sharded_ckpt, args.device)

    resolve_device(args.device)  # the resume's device: raise now, not after phase 1
    if args.nproc < 2 or ACC_CHUNKS % args.nproc:
        raise ValueError(f"--nproc must be at least 2 and divide {ACC_CHUNKS}, got {args.nproc}")
    extra = ["--sharded-ckpt"] if args.sharded_ckpt else []
    wd = pathlib.Path(tempfile.mkdtemp(prefix="fault_demo_"))
    try:
        failure = _fault(args.nproc, wd, extra)
        if failure:
            print(f"fault demo: FAIL ({failure})")
            return 1
        device = ["--device", args.device] if args.device is not None else []
        r = subprocess.run([sys.executable, "-m", MODULE, "--resume", "--workdir", str(wd),
                            *extra, *device], env=child_env(), timeout=TIMEOUT_S)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    print("fault demo:", "OK" if r.returncode == 0 else "FAIL")
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
