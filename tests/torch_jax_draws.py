"""What JAX draws where the port must draw the same, as constants.

The card's machine has no JAX, so the card tests (tests/test_torch_cuda.py)
hold the port to these tables; tests/test_torch_jax_random.py holds the
tables to `jax.random` and `csgn_tpu` on the CPU (JAX 0.9.0, partitionable
threefry).  If a seed or a draw here changes, recompute the constants with
JAX on the CPU: that test says which differ.  This module imports no JAX.
"""

import numpy as np

from csgn_tpu_torch import rng

SEED = 20261016
MAIN_T = 4096             # bits per encrypt batch of the main path

# `rng_vectors(SEED)` under jax.random.
RNG_VECTORS = {
    "key_data": [0, 20261016],
    "split": [[202623531, 735280029], [3252887076, 734064994], [1821268157, 2867172126]],
    "fold_in_7": [2138856170, 644651993],
    "bits": [[666939830, 3928223558, 3328953251, 990424313],
             [96083914, 2316963648, 2561000205, 1494270259]],
    "randint_16": [12, 11, 9, 4, 2, 14, 10, 5],
    "randint_2p31m1": [1623753116, 115300587, 380645385, 281154532],
    "bernoulli": [1, 0, 1, 1, 1, 1, 1, 1],
    "permutation_16": [1, 3, 2, 6, 0, 5, 14, 11, 9, 8, 4, 12, 7, 15, 10, 13],
    "permutation_1247_head": [295, 1036, 630, 716, 232, 1122, 827, 317, 868, 125, 44, 475],
}

# The main path at Context(1247, 16), derived as the JAX CLI's demo derives
# its keys, ``keys = jax.random.split(jax.random.key(SEED), 4)``: the secret
# key from keys[0], and the words (sha-256, the first 32 hex digits) of the
# two `main_bits()` batches encrypted on the default engine under keys[1]
# and keys[2].
MAIN_KEY_INDICES = [250, 25, 807, 727, 849, 795, 916, 51, 1146, 1193, 203, 414, 366, 997, 141,
                    360]
MAIN_WORDS_SHA256 = ("d8052a3c658141cec08ff496258c894b", "861b8eec60fd8c40a520f7cecc0856b5")

# What the JAX examples draw at their default seeds: voting's yes votes of
# MAIN_T voters, netlist_service's reserve and qualified bids (8 bids of 16
# bits); neither depends on the Context.
VOTING_YES = 3670
AUCTION = (6899, [1, 1, 1, 1, 0, 1, 1, 0])


def rng_vectors(seed: int) -> dict:
    """`RNG_VECTORS`' draws, from the port's rng."""
    k = rng.key(seed)
    data = lambda key: rng.key_data(key).tolist()  # noqa: E731
    return {
        "key_data": data(k),
        "split": [data(x) for x in rng.split(k, 3)],
        "fold_in_7": data(rng.fold_in(k, 7)),
        "bits": rng.bits(k, (2, 4)).tolist(),
        "randint_16": rng.randint(k, (8,), 0, 16).tolist(),
        "randint_2p31m1": rng.randint(k, (4,), 0, 2**31 - 1).tolist(),
        "bernoulli": rng.bernoulli(k, 0.9, (8,)).astype(int).tolist(),
        "permutation_16": rng.permutation(k, 16).tolist(),
        "permutation_1247_head": rng.permutation(k, 1247)[:12].tolist(),
    }


def main_bits() -> list:
    """The main path's two batches of MAIN_T bits, each of odd parity."""
    draws = np.random.default_rng(SEED)
    out = []
    for _ in range(2):
        bits = draws.integers(0, 2, MAIN_T).astype(np.int32)
        if bits.sum() % 2 == 0:
            bits[0] ^= 1
        out.append(bits)
    return out
