"""Plain PyTorch reference of the re-key: a product rotated to a reader's
permuted key, and that key.

Written from the scheme's definition (certFHE/CSGN: src/Ciphertext.cpp:33-34
and src/SecretKey.cpp:232-259), on any device, with no code of the program
under test; the product and the match are `csgn`'s:

* a permutation π of the bit positions [0, n) moves a chunk bit by bit: out
  bit i = in bit π[i] for i < n, and the bits from n to the end of the last
  word are 0;
* the rotated key is the positions { i : π[i] ∈ s } = π⁻¹[s], ascending
  (src/SecretKey.cpp:244-250), and Dec_{π(k)}(π(c)) = Dec_k(c).

The rotation unpacks MSB-first, gathers and repacks in blocks of
`ROTATE_CHUNKS` chunks, so that a product of 2^24 chunks is checked on the
card within a few hundred MB at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from . import csgn

__all__ = ["ROTATE_CHUNKS", "rotate", "rotated_positions", "check_rotated"]

ROTATE_CHUNKS = 1 << 15  # chunks a block: [W * 32, ROTATE_CHUNKS] int64 is 335 MB at W = 40


def rotate(words: torch.Tensor, perm) -> torch.Tensor:
    """``words [W, C]`` with every chunk moved by `perm` (int ``[n]``, gather
    form: out bit i = in bit perm[i]); a new ``[W, C]`` int32."""
    w, c = words.shape
    perm = np.asarray(perm, dtype=np.int64)
    n = len(perm)
    if n > 32 * w or (n and (perm.min() < 0 or perm.max() >= n)):
        raise ValueError(f"a permutation of {n} positions does not fit {w} words")
    dev = words.device
    # Output bit i reads word src[i] at shift 31 - i % 32 of it; the bits
    # past n read the zero word appended as row w.
    src = np.full(32 * w, 32 * w, dtype=np.int64)
    src[:n] = perm
    row = torch.from_numpy(src // 32).to(dev)
    shift = torch.from_numpy(31 - src % 32).to(dev)[:, None]
    place = torch.arange(31, -1, -1, device=dev, dtype=torch.int64).repeat(w)[:, None]
    out = torch.empty_like(words)
    for c0 in range(0, c, ROTATE_CHUNKS):
        x = words[:, c0:c0 + ROTATE_CHUNKS].to(torch.int64) & 0xFFFFFFFF
        x = torch.cat([x, torch.zeros_like(x[:1])])
        bits = (x.index_select(0, row) >> shift) & 1           # [W * 32, c'], MSB-first
        packed = (bits << place).view(w, 32, -1).sum(dim=1)    # < 2^32
        out[:, c0:c0 + ROTATE_CHUNKS] = (packed - ((packed >> 31) << 32)).to(torch.int32)
    return out


def rotated_positions(positions, perm) -> np.ndarray:
    """The rotated key's positions: sorted π⁻¹[s] of the key's `positions`."""
    inv = np.argsort(np.asarray(perm, dtype=np.int64))
    return np.sort(inv[np.asarray(positions, dtype=np.int64)])


def check_rotated(rot, a: torch.Tensor, b: torch.Tensor, perm,
                  mask: torch.Tensor) -> tuple[int, int]:
    """``(words that differ, Dec_k parity)`` of the product of `a` and `b`
    rotated by `perm`, against the program's rotated product `rot` ``[W, t1 *
    t2]`` (i-major, on the reference's device); `mask` is the key k's.  Rows
    of a are taken in `csgn.BLOCK_BYTES` blocks, as `csgn.check_product`
    does, and each block's product is rotated before it is compared."""
    w, t1 = a.shape
    t2 = b.shape[1]
    rows = max(1, csgn.BLOCK_BYTES // (4 * w * t2))
    wrong, count = 0, 0
    for i0 in range(0, t1, rows):
        i1 = min(t1, i0 + rows)
        ref = csgn.cross_and(a[:, i0:i1], b)
        count += csgn.match_count(ref, mask)
        wrong += int((rot[:, i0 * t2:i1 * t2] != rotate(ref, perm)).sum())
    return wrong, count & 1
