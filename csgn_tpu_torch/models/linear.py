"""GF(2) linear maps over encrypted bits.

A public binary matrix applied to a vector of ciphertexts needs only
homomorphic XOR: ``out_i = XOR_j M[i, j] & in_j`` selects and concatenates
chunks — no multiplies, no growth beyond the row's popcount.  This covers
syndrome computation, parity-check evaluation, and any public linear layer
over encrypted bits.
"""

from __future__ import annotations

import numpy as np

from csgn_tpu_torch.ciphertext import Ciphertext
from csgn_tpu_torch.ops import core

__all__ = ["matvec_f2"]


def matvec_f2(matrix: np.ndarray, cts: list[Ciphertext]) -> list[Ciphertext]:
    """Apply a public 0/1 matrix [rows, cols] to encrypted bits (len cols).

    Row i's output ciphertext concatenates the chunks of every selected
    input; decrypt gives XOR of the selected bits.  Rows that select nothing
    are rejected (the scheme has no canonical encryption of constant 0
    without randomness — XOR in a fresh E(0) instead).
    """
    m = np.asarray(matrix)
    if m.ndim != 2 or m.shape[1] != len(cts):
        raise ValueError(f"matrix {m.shape} does not match {len(cts)} inputs")
    ctx = cts[0].ctx
    for ct in cts:
        if ct.ctx != ctx:
            raise ValueError("context mismatch among inputs")

    # Canonicalize once up front: a lazy-ordered input selected by many rows
    # would otherwise pay its canonicalization gather once per row.
    wts = [ct.canonical().wt for ct in cts]

    out = []
    for i in range(m.shape[0]):
        sel = [wts[j] for j in range(m.shape[1]) if m[i, j] & 1]
        if not sel:
            raise ValueError(f"row {i} selects no inputs (no public zero encryption)")
        words = sel[0]
        for wt in sel[1:]:
            words = core.add_chunks(words, wt)
        out.append(Ciphertext(words, ctx))
    return out
