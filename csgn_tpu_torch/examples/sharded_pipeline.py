"""Sharded end-to-end pipeline over a mesh of ranks.

The JAX package's examples/sharded_pipeline.py on the port: encrypt a batch
(batch-sharded, each rank its own block of bits), square it with the
all-gather multiply, decrypt with an all-reduced parity — the whole SPMD
lifecycle of `csgn_tpu_torch.parallel` on the job's ranks.

It runs in the process group the caller has joined (every rank calls
`main`), or, when there is none, as a job of one rank of its own: NCCL on
the CUDA device, gloo with ``device="cpu"``.

Run: python -m csgn_tpu_torch.examples.sharded_pipeline [--batch 64] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from csgn_tpu_torch import Context, SecretKey, rng
from csgn_tpu_torch.parallel import (chunk_mesh, sharded_decrypt_parity,
                                     sharded_encrypt_bits_invariant, sharded_mul_allgather)
from csgn_tpu_torch.tools._jobs import job


def main(batch: int = 64, n: int = 1247, d: int = 16, device=None) -> dict:
    with job(device) as dev:
        ctx = Context(n, d)
        mesh = chunk_mesh()
        nd = mesh.shape["c"]
        batch = -(-batch // nd) * nd
        bl = batch // nd
        me = mesh.coord("c")

        sk = SecretKey.generate(ctx, rng.key(0), dev)
        bits = np.arange(batch) % 2
        mine = torch.from_numpy(bits[me * bl:(me + 1) * bl].astype(np.int32)).to(dev)

        words = sharded_encrypt_bits_invariant(rng.key(1), mine, *sk.encrypt_operands, ctx.n,
                                               ctx.d, mesh)   # this rank's [W, batch/nd]
        prod = sharded_mul_allgather(words, words, mesh)      # its [W, batch/nd * batch]
        mask = sk.mask_words
        parity_in = int(sharded_decrypt_parity(words, mask, mesh))
        parity_out = int(sharded_decrypt_parity(prod, mask, mesh))

        expect = int(bits.sum() % 2)
        if parity_in != expect or parity_out != (expect & expect):
            raise RuntimeError(f"parities {parity_in}, {parity_out}; expected {expect}")
        return {
            "devices": nd,
            "batch": batch,
            "product_chunks": int(prod.shape[-1]) * nd,
            "parity": parity_out,
        }


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n", type=int, default=1247)
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA "
                                                   "device)")
    args = ap.parse_args()
    print(main(args.batch, args.n, args.d, device=args.device))
