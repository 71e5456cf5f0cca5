"""Key-rotation fleet: B ciphertexts re-keyed under B DISTINCT permutations.

The JAX package's examples/key_rotation.py on the port.  A permutation π
moves a ciphertext from key k to key π(k) without decrypting
(Dec_{π(k)}(π(c)) = Dec_k(c), reference src/SecretKey.cpp:232-259).  A
serving fleet rotating many clients' keys at once applies a different π to
every ciphertext: one launch of the Beneš kernel over the whole batch
(`CiphertextBatch.apply_permutations`, K9: all plans share the delta
schedule, so plan i's stage masks are picked by the batch index).

Flow: encrypt a fleet under one key -> grow each ciphertext by a batched
multiply (K1 on [B, W, C]) -> decrypt the grown fleet in one batched launch
(K3) -> rotate every element under its own permutation -> each client
decrypts under its own rotated key.

Run: python -m csgn_tpu_torch.examples.key_rotation [--fleet 8] [--n 1247] [--d 16] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from csgn_tpu_torch import CiphertextBatch, Context, Permutation, SecretKey, rng
from csgn_tpu_torch._device import resolve_device


def main(fleet: int = 8, n: int = 1247, d: int = 16, seed: int = 0, device=None) -> dict:
    dev = resolve_device(device)
    ctx = Context(n, d)
    keys = rng.split(rng.key(seed), 3 + fleet)
    sk = SecretKey.generate(ctx, keys[0], dev)

    # Fleet of fresh ciphertexts (one batched launch), grown by one
    # homomorphic multiply so the rotation runs on multi-chunk payloads.
    bits = np.random.default_rng(seed).integers(0, 2, fleet, dtype=np.uint8).astype(np.int32)
    other = np.ones(fleet, np.int32)  # AND with 1: bit-preserving
    batch = CiphertextBatch.from_fresh(sk.encrypt_batch(bits, keys[1]), ctx)
    batch = batch + CiphertextBatch.from_fresh(sk.encrypt_batch(other, keys[2]), ctx)
    grown = batch * batch  # 4 chunks/element: (b ^ 1)^2 = b ^ 1
    want = [int(b) ^ 1 for b in bits]
    grown_bits = sk.decrypt_batch(grown).tolist()
    if grown_bits != want:
        raise RuntimeError(f"grown fleet decrypts to {grown_bits}, expected {want}")

    # One rotation per element, all in one kernel launch.
    perms = [Permutation.random(ctx, keys[3 + i]) for i in range(fleet)]
    rotated = grown.apply_permutations(perms)

    # Every client decrypts under its own rotated key.
    decs = [int(sk.apply_permutation(perms[i]).decrypt(rotated[i])) for i in range(fleet)]
    if decs != want:
        raise RuntimeError(f"rotated decrypts {decs} != {want}")

    print(f"fleet={fleet}: rotated under {fleet} distinct permutations, "
          f"all client decrypts correct")
    return {"fleet": fleet, "decrypted": decs, "expected": want}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--fleet", type=int, default=8)
    ap.add_argument("--n", type=int, default=1247)
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA "
                                                   "device)")
    a = ap.parse_args()
    main(a.fleet, a.n, a.d, a.seed, device=a.device)
