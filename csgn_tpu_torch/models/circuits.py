"""Homomorphic boolean circuits over CSGN ciphertexts.

Native gates: ``+`` is XOR (chunk concat, reference src/Ciphertext.cpp:107-122)
and ``*`` is AND (chunk cross product, src/Ciphertext.cpp:153-163).  Derived
gates need a public encryption of the constant 1 (for NOT), which `Gates`
carries.  Every derived gate is expressed in {XOR, AND, 1} normal form.

Chunk growth: XOR adds chunk counts, AND multiplies them — deep circuits grow
ciphertexts superlinearly (the scheme is *bounded* homomorphic).  `Gates`
tracks worst-case growth so circuit authors can budget; see
`Ciphertext.chunks`.
"""

from __future__ import annotations

from csgn_tpu_torch.ciphertext import Ciphertext

__all__ = ["Gates"]


class Gates:
    """Boolean gate vocabulary bound to a public encryption of 1.

    ``one`` must be a fresh encryption of 1 under the evaluation key.  All
    gates are pure: they return new ciphertexts.
    """

    def __init__(self, one: Ciphertext):
        self.one = one

    # -- unary/binary gates --------------------------------------------------

    @staticmethod
    def xor(a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return a + b

    @staticmethod
    def and_(a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return a * b

    def not_(self, a: Ciphertext) -> Ciphertext:
        return a + self.one

    def or_(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        # a | b = a ^ b ^ (a & b)
        return a + b + (a * b)

    def nand(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self.not_(a * b)

    def nor(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self.not_(self.or_(a, b))

    def xnor(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self.not_(a + b)

    def mux(self, sel: Ciphertext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        # sel ? a : b  =  (sel & a) ^ (~sel & b)
        return (sel * a) + (self.not_(sel) * b)

    # -- arithmetic ----------------------------------------------------------

    @staticmethod
    def half_adder(a: Ciphertext, b: Ciphertext) -> tuple[Ciphertext, Ciphertext]:
        """(sum, carry)"""
        return a + b, a * b

    @staticmethod
    def full_adder(
        a: Ciphertext, b: Ciphertext, cin: Ciphertext
    ) -> tuple[Ciphertext, Ciphertext]:
        """(sum, carry_out): sum = a^b^cin, cout = (a&b) ^ (cin & (a^b))."""
        axb = a + b
        return axb + cin, (a * b) + (cin * axb)

    def ripple_add(
        self, a_bits: list[Ciphertext], b_bits: list[Ciphertext], cin: Ciphertext | None = None
    ) -> tuple[list[Ciphertext], Ciphertext]:
        """LSB-first multi-bit ripple-carry adder: returns (sum_bits, carry).

        Chunk growth is exponential in width (each carry chains an AND); this
        is the canonical bounded-HE depth stress test, not a production adder.
        """
        if len(a_bits) != len(b_bits):
            raise ValueError("operand widths differ")
        out: list[Ciphertext] = []
        carry = cin
        for a, b in zip(a_bits, b_bits):
            if carry is None:
                s, carry = self.half_adder(a, b)
            else:
                s, carry = self.full_adder(a, b, carry)
            out.append(s)
        return out, carry

    def equals(self, a_bits: list[Ciphertext], b_bits: list[Ciphertext]) -> Ciphertext:
        """Bit-vector equality: AND over XNOR of each bit pair."""
        if len(a_bits) != len(b_bits):
            raise ValueError("operand widths differ")
        acc: Ciphertext | None = None
        for a, b in zip(a_bits, b_bits):
            eq = self.xnor(a, b)
            acc = eq if acc is None else acc * eq
        assert acc is not None
        return acc

    @staticmethod
    def parity(bits: list[Ciphertext]) -> Ciphertext:
        """XOR-reduce a list of encrypted bits (cheap: pure concat)."""
        acc = bits[0]
        for b in bits[1:]:
            acc = acc + b
        return acc
