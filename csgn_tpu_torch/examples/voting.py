"""Encrypted-ballot demo: parity and unanimity over homomorphic bits.

The JAX package's examples/voting.py on the port.  Each voter encrypts one
bit (one batched encrypt for the whole electorate); the untrusted tally
server combines ciphertexts without the key:

  * parity of all votes       — the batch is already the ``+`` fold
    (chunks concatenated);
  * unanimity (all voted 1)   — the ``*`` fold, `pipeline.mul_chain` over
    one-chunk ciphertexts (1 chunk per step: 1 x 1).

Run: python -m csgn_tpu_torch.examples.voting [--voters 64] [--n 1247] [--d 16] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from csgn_tpu_torch import Ciphertext, Context, SecretKey, rng
from csgn_tpu_torch._device import resolve_device
from csgn_tpu_torch.pipeline import mul_chain


def main(voters: int = 64, n: int = 1247, d: int = 16, seed: int = 0, device=None) -> dict:
    dev = resolve_device(device)
    ctx = Context(n, d)
    k_key, k_enc, k_votes = rng.split(rng.key(seed), 3)

    # Election authority: keygen.  Voters: encrypt one bit each (batched).
    sk = SecretKey.generate(ctx, k_key, dev)
    votes = rng.bernoulli(k_votes, 0.9, (voters,)).astype(np.int32)
    words = sk.encrypt_batch(votes, k_enc)                               # [W, voters]

    # --- untrusted tally server: no key from here on -----------------------
    parity_ct = Ciphertext(words, ctx)
    per_voter = [Ciphertext(words[:, i:i + 1], ctx) for i in range(voters)]
    unanimity_ct = mul_chain(per_voter)                                  # 1 chunk (1^voters)

    # --- authority decrypts ------------------------------------------------
    parity = int(sk.decrypt(parity_ct))
    unanimous = int(sk.decrypt(unanimity_ct))

    expect_parity = int(votes.sum() % 2)
    expect_unanimous = int(votes.all())
    if (parity, unanimous) != (expect_parity, expect_unanimous):
        raise RuntimeError(f"tally decrypts to parity {parity}, unanimity {unanimous}; "
                           f"the votes give {expect_parity}, {expect_unanimous}")
    return {
        "voters": voters,
        "yes_votes": int(votes.sum()),
        "parity": parity,
        "unanimous": unanimous,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--voters", type=int, default=64)
    ap.add_argument("--n", type=int, default=1247)
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA "
                                                   "device)")
    args = ap.parse_args()
    print(main(args.voters, args.n, args.d, device=args.device))
