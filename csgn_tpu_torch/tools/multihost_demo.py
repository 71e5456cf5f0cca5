"""Multi-process SPMD validation: the sharded multiply and decrypt over a
job of ``--nproc`` ranks, against the single-process oracle.

The port of the JAX package's tools/multihost_demo.py.  The driver starts
``--nproc`` processes (default 2), one rank each, which join one job through
`parallel.initialize` (rendezvous at a ``file://`` store in a temporary
directory).  Every rank builds the same inputs at Context(1247, 16), keeps
its own block of each, and runs `sharded_mul_allgather` (or
`sharded_mul_broadcast`, with b replicated, when b's chunk count does not
divide the ranks) and `sharded_decrypt_parity` over the global mesh; it
checks its block of the product and the parity against the one-process
product on the CPU.

With ``--device cpu`` the ranks are CPU processes over gloo.  Without it
they run over NCCL, rank r on CUDA device r, and the driver raises unless
there are ``--nproc`` CUDA devices; there is no fallback.

Run: python -m csgn_tpu_torch.tools.multihost_demo [--nproc N] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

from csgn_tpu_torch import Context, SecretKey, parallel
from csgn_tpu_torch._device import resolve_device
from csgn_tpu_torch.layout import words_from_numpy
from csgn_tpu_torch.ops import kernels
from csgn_tpu_torch.tools._jobs import start_ranks, wait_ranks

TIMEOUT_S = 300


def worker(rank: int, store: str, nproc: int, t1: int, t2: int, device) -> int:
    dev = parallel.initialize(f"file://{store}", nproc, rank, device=device)
    try:
        mesh = parallel.global_chunk_mesh()
        me = mesh.coord("c")
        ctx = Context(1247, 16)
        rng = np.random.default_rng(0)  # the same on every rank: replicated inputs
        a = rng.integers(0, 2**32, (ctx.words32, t1), dtype=np.uint32) & ctx.valid_mask[:, None]
        b = rng.integers(0, 2**32, (ctx.words32, t2), dtype=np.uint32) & ctx.valid_mask[:, None]
        sk = SecretKey(ctx, np.arange(ctx.d, dtype=np.int32) * 71 + 3, dev)

        def block(x):
            c = x.shape[-1] // nproc
            return words_from_numpy(np.ascontiguousarray(x[:, me * c:(me + 1) * c]), dev)

        if t2 % nproc == 0:
            prod = parallel.sharded_mul_allgather(block(a), block(b), mesh)
        else:  # the small operand stays replicated
            prod = parallel.sharded_mul_broadcast(block(a), words_from_numpy(b, dev), mesh)
        parity = int(parallel.sharded_decrypt_parity(prod, sk.mask_words, mesh))

        # This rank's block of the one-process product, on the CPU.
        cpu_a, cpu_b = words_from_numpy(a, "cpu"), words_from_numpy(b, "cpu")
        want = kernels.mul_chunks_plain(cpu_a, cpu_b)
        want_parity = int(kernels.decrypt_parity_plain(want, sk.mask_words.cpu()))
        cl = prod.shape[-1]
        ok_words = torch.equal(prod.cpu(), want[:, me * cl:(me + 1) * cl])
        ok = ok_words and parity == want_parity
        print(f"[rank {rank}] {mesh.shape['c']} ranks on {dev}: words_exact={ok_words} "
              f"parity={parity} want={want_parity} -> {'OK' if ok else 'FAIL'}", flush=True)
        return 0 if ok else 1
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--t1", type=int, default=16)
    ap.add_argument("--t2", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cpu: gloo ranks on the CPU (default: one CUDA device a rank, NCCL)")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.t1 % args.nproc:
        raise ValueError(f"--t1 {args.t1} must be a multiple of --nproc {args.nproc}")
    if args.worker is not None:
        return worker(args.worker, args.store, args.nproc, args.t1, args.t2, args.device)

    dev = resolve_device(args.device)
    if dev.type == "cuda" and torch.cuda.device_count() < args.nproc:
        raise RuntimeError(f"{args.nproc} NCCL ranks need {args.nproc} CUDA devices, this "
                           f"machine has {torch.cuda.device_count()}")
    extra = ["--t1", str(args.t1), "--t2", str(args.t2)]
    if args.device is not None:
        extra += ["--device", args.device]
    with tempfile.TemporaryDirectory(prefix="multihost_demo_") as tmp:
        procs = start_ranks("csgn_tpu_torch.tools.multihost_demo", args.nproc,
                            f"{tmp}/store", extra)
        rc = max(wait_ranks(procs, TIMEOUT_S))
    print("multihost demo:", "OK" if rc == 0 else "FAIL")
    return rc


if __name__ == "__main__":
    sys.exit(main())
