"""Inputs made from ``--seed``: the key's positions and ciphertext words.

The benchmark makes them itself and hands the same to the program and to the
reference.  Words are drawn on the run's device by a `torch.Generator`, in a
few large calls; choices of order and of positions come from numpy on the
host.  Every stream is split from the seed by name, so adding a stream never
moves another.

A fresh chunk is what the scheme's encryption gives (reference
src/SecretKey.cpp:35-80): random bits below n, all d key positions set for
the bit 1, and one of them, chosen at random, clear for the bit 0.  A
ciphertext of t such chunks is the sum of t fresh encryptions.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from portbench.reference import csgn

__all__ = ["stream_seed", "host_rng", "device_generator", "key_positions", "fresh_chunks"]


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the stream `name` of run seed `seed` (any integer)."""
    digest = hashlib.sha256(f"{seed}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def host_rng(seed: int, name: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, name))


def device_generator(seed: int, name: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, name))
    return gen


def key_positions(seed: int, n: int, d: int) -> np.ndarray:
    """The key's d distinct bit positions in [0, n), in random order."""
    return host_rng(seed, "key").choice(n, size=d, replace=False).astype(np.int64)


def fresh_chunks(bits: torch.Tensor, positions: np.ndarray, n: int,
                 gen: torch.Generator) -> torch.Tensor:
    """Fresh chunks of `bits` (0/1, any shape ``S``), chunk-major
    ``int32[*S, W]`` on the bits' device."""
    dev = bits.device
    w = csgn.words_per_chunk(n)
    shape = tuple(bits.shape)
    words = torch.randint(-2**31, 2**31, (*shape, w), dtype=torch.int32, device=dev,
                          generator=gen)
    words &= torch.from_numpy(csgn.valid_words(n)).to(dev)
    ones = bits.to(torch.bool)
    words |= torch.where(ones[..., None], torch.from_numpy(csgn.mask_words(positions, n)).to(dev),
                         torch.zeros((), dtype=torch.int32, device=dev))
    # For the bit 0, clear one key position drawn per chunk.
    pos = torch.from_numpy(np.asarray(positions, dtype=np.int64)).to(dev)
    pick = pos[torch.randint(0, len(pos), shape, device=dev, generator=gen)]
    clear = torch.zeros_like(words)
    bitval = torch.bitwise_left_shift(torch.ones_like(pick), 31 - pick % 32)
    bitval = (bitval - ((bitval >> 31) << 32)).to(torch.int32)  # 2^31 is int32's -2^31
    clear.scatter_(-1, (pick // 32)[..., None], torch.where(ones, 0, bitval)[..., None])
    return words & ~clear
