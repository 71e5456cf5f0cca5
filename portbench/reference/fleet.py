"""Plain PyTorch reference of the key-rotation fleet: B stored ciphertexts,
element i re-keyed with its own reader's permutation π_i, and each read out
under that reader's key.

Written from the scheme's definition (certFHE/CSGN: src/Ciphertext.cpp:7-82
and src/SecretKey.cpp:232-259, as tests/permutations.cpp uses them), on any
device, with no code of the program under test; the rotation and the rotated
key are `rekey`'s, the match `csgn`'s:

* element i of a fleet is moved chunk by chunk by π_i: out bit p = in bit
  π_i[p] for p < n, and the bits from n to the end of the last word are 0;
* reader i holds π_i(k), the positions sorted π_i⁻¹[k], and
  Dec_{π_i(k)}(π_i(c)) = Dec_k(c): the parity of the chunks that hold every
  position of the key.

Each ciphertext is rotated in `rekey.ROTATE_CHUNKS` blocks and matched in
`MATCH_CHUNKS` blocks, so that a fleet of 2^22 chunks is checked on the card
one element at a time.
"""

from __future__ import annotations

import torch

from . import csgn, rekey

__all__ = ["MATCH_CHUNKS", "rotate", "parity", "check"]

MATCH_CHUNKS = 1 << 20  # chunks a block of the match: [W, MATCH_CHUNKS] bool is 42 MB at W = 40


def rotate(words: torch.Tensor, perms) -> torch.Tensor:
    """``words [B, W, C]`` with element i moved by ``perms[i]`` (int ``[n]``,
    gather form); a new ``[B, W, C]`` int32."""
    if words.dim() != 3 or len(perms) != words.shape[0]:
        raise ValueError(f"{len(perms)} permutations for a fleet of shape {tuple(words.shape)}")
    return torch.stack([rekey.rotate(w, p) for w, p in zip(words, perms)])


def parity(words: torch.Tensor, positions, n: int) -> int:
    """Dec under the key at `positions`: the parity of the chunks of ``words
    [W, C]`` that hold every one of them."""
    mask = torch.from_numpy(csgn.mask_words(positions, n)).to(words.device)
    count = 0
    for c0 in range(0, words.shape[1], MATCH_CHUNKS):
        count += csgn.match_count(words[:, c0:c0 + MATCH_CHUNKS], mask)
    return count & 1


def check(rot: torch.Tensor, words: torch.Tensor, perm, positions, n: int) -> tuple[int, int]:
    """``(words that differ, bit wrong)`` of the program's rotation `rot` of
    the stored ciphertext `words` (both ``[W, C]`` on the reference's
    device) by `perm`: its words against the reference's rotation, and its
    bit under the rotated key against Dec_k of the stored ciphertext (1 if
    they differ)."""
    wrong = int((rot != rekey.rotate(words, perm)).sum())
    bit = parity(rot, rekey.rotated_positions(positions, perm), n)
    return wrong, int(bit != parity(words, positions, n))
