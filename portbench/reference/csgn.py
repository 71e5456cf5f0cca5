"""Plain PyTorch reference of the CSGN operations the cells drive.

Written from the scheme's definition (certFHE/CSGN: src/Ciphertext.cpp:153-163
for the product, src/SecretKey.cpp:126-140 for the decrypt), on any device,
with no code of the program under test:

* a chunk is n bits packed MSB-first into W = 2 * ceil(n / 64) 32-bit words
  (bit j in word j // 32 at shift 31 - j % 32), held as int32, word-major
  ``[W, chunks]``;
* the product of ciphertexts of t1 and t2 chunks is the t1 * t2 chunks
  ``a_i AND b_j``, chunk i * t2 + j (i-major);
* a chunk matches the key when it holds every one of the key's d bit
  positions, and a ciphertext decrypts to the parity of its matching chunks.

Large products are computed and compared in blocks of rows, so that the
reference never holds a second copy of a product the size of the program's.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["words_per_chunk", "mask_words", "valid_words", "cross_and", "matches", "match_count",
           "check_product", "control_product", "BLOCK_BYTES"]

# Bytes of one block of a reference product (a few passes over it fit in any card).
BLOCK_BYTES = 1 << 28


def words_per_chunk(n: int) -> int:
    return 2 * (-(-n // 64))


def mask_words(positions, n: int) -> np.ndarray:
    """The chunk with exactly the bits at `positions` set, as int32[W]."""
    words = np.zeros(words_per_chunk(n), dtype=np.uint64)
    for p in np.asarray(positions, dtype=np.int64).tolist():
        if not 0 <= p < n:
            raise ValueError(f"bit position {p} outside [0, {n})")
        words[p // 32] |= np.uint64(1) << np.uint64(31 - p % 32)
    return words.astype(np.uint32).view(np.int32)


def valid_words(n: int) -> np.ndarray:
    """The chunk with every bit j < n set, as int32[W]."""
    return mask_words(np.arange(n), n)


def cross_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[..., W, t1] x [..., W, t2] -> [..., W, t1 * t2]``, chunk i * t2 + j
    = a_i & b_j."""
    return (a[..., :, :, None] & b[..., :, None, :]).flatten(-2)


def matches(words: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """bool ``[..., C]``: the chunks of ``words [..., W, C]`` that hold every
    bit of ``mask [W]``."""
    m = mask[:, None]
    return ((words & m) == m).all(dim=-2)


def match_count(words: torch.Tensor, mask: torch.Tensor) -> int:
    """Chunks of ``words [W, C]`` that hold every bit of ``mask [W]``."""
    return int(matches(words, mask).sum())


def check_product(prod, a: torch.Tensor, b: torch.Tensor,
                  mask: torch.Tensor) -> tuple[int, int]:
    """``(words that differ, reference parity)`` of the product of `a` and `b`.

    `prod` is the program's product ``[W, t1 * t2]`` on the reference's
    device, or None to take only the parity.
    """
    w, t1 = a.shape
    t2 = b.shape[1]
    rows = max(1, BLOCK_BYTES // (4 * w * t2))
    wrong, count = 0, 0
    for i0 in range(0, t1, rows):
        i1 = min(t1, i0 + rows)
        ref = cross_and(a[:, i0:i1], b)
        count += match_count(ref, mask)
        if prod is not None:
            wrong += int((prod[:, i0 * t2:i1 * t2] != ref).sum())
    return wrong, count & 1


def control_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The check's control: the product in the swapped chunk order (chunk
    j * t1 + i holds a_i & b_j).  It decrypts to the same parity, which is why
    a later change might be tempted to return it, but it breaks the
    guarantee that every product word is exact."""
    return cross_and(b, a)
