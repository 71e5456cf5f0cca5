"""Private table lookup: select a public table entry by an ENCRYPTED address.

The classic PIR-flavored primitive this scheme supports naturally:

    out = XOR_{i : table[i] = 1}  match_i(addr)

where ``match_i = AND_j (addr_j XNOR i_j)`` is the encrypted one-hot of the
address.  The server learns nothing about the address; the result decrypts to
``table[addr]``.  Because the table is public, selected match terms are
combined with XOR only — no extra multiplies beyond the address-match ANDs.

Chunk growth: each match is a k-deep AND of 2-chunk XNOR terms → ~2^k chunks;
practical for small k (lookup tables, S-boxes), with `SecretKey.recrypt` as
the key-side reset for larger addresses.
"""

from __future__ import annotations

from csgn_tpu_torch.ciphertext import Ciphertext
from csgn_tpu_torch.models.circuits import Gates

__all__ = ["private_lookup"]


def private_lookup(gates: Gates, addr_bits: list[Ciphertext], table: list[int]) -> Ciphertext:
    """Evaluate table[addr] homomorphically.

    addr_bits: encrypted address, LSB first (k bits).
    table: public 0/1 list of length 2^k with at least one 1 set (the scheme
    has no deterministic encryption of 0; XOR a fresh E(0) into the result if
    an all-zero table row must be representable).
    """
    k = len(addr_bits)
    if len(table) != 1 << k:
        raise ValueError(f"table length {len(table)} != 2^{k}")

    selected: list[Ciphertext] = []
    for i, bit in enumerate(table):
        if not (bit & 1):
            continue
        # match_i = AND_j (addr_j XNOR i_j); XNOR with constant 1 is identity,
        # with constant 0 is NOT.
        term: Ciphertext | None = None
        for j in range(k):
            factor = addr_bits[j] if (i >> j) & 1 else gates.not_(addr_bits[j])
            term = factor if term is None else term * factor
        assert term is not None
        selected.append(term)

    if not selected:
        raise ValueError("all-zero table: XOR a fresh E(0) externally instead")
    out = selected[0]
    for term in selected[1:]:
        out = out + term
    return out
