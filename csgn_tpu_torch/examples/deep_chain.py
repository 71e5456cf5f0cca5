"""Deep multiplication chain with growth budgeting and key-side recrypt.

The JAX package's examples/deep_chain.py on the port.  Chunk counts
multiply under ``*`` (the scheme is bounded), so a long circuit interleaves
homomorphic work (server) with `SecretKey.recrypt` growth resets (key
holder): whenever the next product would pass ``recrypt_at`` chunks, the
accumulator is re-encrypted as one fresh chunk.  Each operand has two
chunks, so a product is 1 x 2 chunks right after a reset (the multiply's
unaligned mode) and even t x 2 otherwise (its aligned mode).

Run: python -m csgn_tpu_torch.examples.deep_chain [--depth 16] [--recrypt-at 4096] [--device cpu]
"""

from __future__ import annotations

import argparse

from csgn_tpu_torch import Context, SecretKey, rng
from csgn_tpu_torch._device import resolve_device
from csgn_tpu_torch.pipeline import chain_chunks


def main(depth: int = 16, recrypt_at: int = 4096, n: int = 95, d: int = 4, seed: int = 0,
         device=None) -> dict:
    dev = resolve_device(device)
    ctx = Context(n, d)
    keys = rng.split(rng.key(seed), 2 * depth + 2)
    sk = SecretKey.generate(ctx, keys[0], dev)

    acc = sk.encrypt(1, keys[1])
    expect = 1
    recrypts = 0
    peak_chunks = 1
    for i in range(depth):
        bit = 1  # all-ones keeps the product alive through full depth
        operand = sk.encrypt(bit, keys[2 * i]) + sk.encrypt(0, keys[2 * i + 1])  # 2 chunks
        if acc.chunks * operand.chunks > recrypt_at:
            acc = sk.recrypt(acc, keys[2 * i + 1])   # growth reset (key holder)
            recrypts += 1
        acc = acc * operand
        expect &= bit
        peak_chunks = max(peak_chunks, acc.chunks)

    got = int(sk.decrypt(acc))
    if got != expect:
        raise RuntimeError(f"chain decrypts to {got}, expected {expect}")
    return {
        "depth": depth,
        "final_chunks": acc.chunks,
        "peak_chunks": peak_chunks,
        "recrypts": recrypts,
        "unbounded_chunks_would_be": chain_chunks([2] * depth),
        "decrypted": got,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--recrypt-at", type=int, default=4096)
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA "
                                                   "device)")
    args = ap.parse_args()
    print(main(args.depth, args.recrypt_at, device=args.device))
