"""SHA-256 compression as a Bristol-Fashion netlist — the published suite's
other flagship (alongside `models.aes`).

Generates the full compression function — message schedule (48 extensions)
+ 64 rounds + the Davies–Meyer feed-forward — in the {XOR, AND, INV, EQ}
basis as a `Netlist`.  One compression over the standard IV hashes any
message that fits a single padded block, so `sha256_pad_one_block` +
`eval_plain` reproduces `hashlib.sha256` exactly (the test oracle), and the
growth-free `eval_expr` path computes the digest of an ENCRYPTED message
homomorphically (tests/test_sha256.py; the reference framework's gate
vocabulary stops at hand-chained pairs,
reference tests/basic_operations.cpp:30-43).

Construction notes
------------------
* 32-bit addition mod 2^32 is a ripple-carry chain (2 AND + 3 XOR per bit,
  carry dropped at bit 31); round constants K_t enter through EQ constant
  wires feeding a normal adder.
* Ch(e,f,g) = (e&f) ^ (~e&g); Maj = (a&b) ^ (a&c) ^ (b&c); the Σ/σ
  rotations are pure rewiring, the σ SHIFTS inject EQ-0 wires.
* AND-depth is ~2000 (64 rounds × a 31-deep carry chain), so homomorphic
  evaluation is expr-path only — materialized growth saturates
  `circuit.CHUNKS_SAT` immediately.

Bit conventions: two input values [block(512), state_in(256)] and one
output value [256], all as BYTES in their standard serialized order (the
block as fed to the compression; the state as the big-endian h0..h7 that
`hashlib.sha256().digest()` emits), each byte LSB-first — wire ``8*i + j``
is bit ``j`` of byte ``i``.  The word<->byte marshalling is pure rewiring
inside the circuit.
"""

from __future__ import annotations

import struct

from csgn_tpu_torch.models.netlist import Netlist, _Builder

__all__ = [
    "sha256_compress",
    "sha256_pad",
    "sha256_pad_one_block",
    "SHA256_IV",
    "SHA256_K",
]

SHA256_IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

SHA256_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)

_Word = list  # 32 wire ids, LSB-first (bit i = coefficient of 2^i)


class _W(_Builder):
    """The shared wire allocator (netlist.py) + cached EQ constant wires
    (the round constants K_t enter the adders through them)."""

    def __init__(self, input_sizes):
        super().__init__(input_sizes)
        self._zero: int | None = None
        self._one: int | None = None

    def zero(self) -> int:
        if self._zero is None:
            self._zero = self.emit("EQ", 0)
        return self._zero

    def one(self) -> int:
        if self._one is None:
            self._one = self.emit("EQ", 1)
        return self._one

    def const_word(self, c: int) -> _Word:
        return [self.one() if (c >> i) & 1 else self.zero() for i in range(32)]


def _add32(w: _W, a: _Word, b: _Word) -> _Word:
    """Ripple-carry addition mod 2^32 (carry out of bit 31 dropped)."""
    out = []
    carry = None
    for i in range(32):
        axb = w.xor(a[i], b[i])
        if carry is None:
            out.append(axb)
            carry = w.and_(a[i], b[i])
        elif i < 31:
            out.append(w.xor(axb, carry))
            carry = w.xor(w.and_(a[i], b[i]), w.and_(carry, axb))
        else:
            out.append(w.xor(axb, carry))
    return out


def _xor_word(w: _W, a: _Word, b: _Word) -> _Word:
    return [w.xor(a[i], b[i]) for i in range(32)]


def _rotr(a: _Word, n: int) -> _Word:
    """LSB-first rotr: out bit i = in bit (i + n) mod 32 — pure rewiring."""
    return [a[(i + n) % 32] for i in range(32)]


def _shr(w: _W, a: _Word, n: int) -> _Word:
    return [a[i + n] if i + n < 32 else w.zero() for i in range(32)]


def _ch(w: _W, e: _Word, f: _Word, g: _Word) -> _Word:
    return [
        w.xor(w.and_(e[i], f[i]), w.and_(w.inv(e[i]), g[i])) for i in range(32)
    ]


def _maj(w: _W, a: _Word, b: _Word, c: _Word) -> _Word:
    return [
        w.xor(
            w.xor(w.and_(a[i], b[i]), w.and_(a[i], c[i])), w.and_(b[i], c[i])
        )
        for i in range(32)
    ]


def sha256_compress() -> Netlist:
    """Build the compression netlist: [block(512), state_in(256)] -> [256].

    ~125k gates (46,840 ANDs); includes the Davies–Meyer feed-forward, so
    chaining calls (or one call on the IV) IS SHA-256.  See the module
    docstring for bit conventions.
    """
    w = _W([512, 256])

    def bytes_to_words(first_bit: int, n_words: int) -> list[_Word]:
        """Big-endian 4-byte groups -> LSB-first 32-bit words (rewiring)."""
        words = []
        for j in range(n_words):
            word = []
            for i in range(32):
                byte_in_word = 3 - i // 8   # big-endian byte order
                word.append(first_bit + 8 * (4 * j + byte_in_word) + i % 8)
            words.append(word)
        return words

    msg = bytes_to_words(0, 16)
    state = bytes_to_words(512, 8)

    # Message schedule: W[t] = σ1(W[t-2]) + W[t-7] + σ0(W[t-15]) + W[t-16].
    sched = list(msg)
    for t in range(16, 64):
        s0 = _xor_word(
            w,
            _xor_word(w, _rotr(sched[t - 15], 7), _rotr(sched[t - 15], 18)),
            _shr(w, sched[t - 15], 3),
        )
        s1 = _xor_word(
            w,
            _xor_word(w, _rotr(sched[t - 2], 17), _rotr(sched[t - 2], 19)),
            _shr(w, sched[t - 2], 10),
        )
        sched.append(
            _add32(w, _add32(w, s1, sched[t - 7]), _add32(w, s0, sched[t - 16]))
        )

    a, b, c, d, e, f, g, h = state
    for t in range(64):
        big_s1 = _xor_word(
            w, _xor_word(w, _rotr(e, 6), _rotr(e, 11)), _rotr(e, 25)
        )
        t1 = _add32(
            w,
            _add32(w, _add32(w, h, big_s1), _ch(w, e, f, g)),
            _add32(w, w.const_word(SHA256_K[t]), sched[t]),
        )
        big_s0 = _xor_word(
            w, _xor_word(w, _rotr(a, 2), _rotr(a, 13)), _rotr(a, 22)
        )
        t2 = _add32(w, big_s0, _maj(w, a, b, c))
        a, b, c, d, e, f, g, h = (
            _add32(w, t1, t2), a, b, c, _add32(w, d, t1), e, f, g,
        )

    final = [
        _add32(w, s, v)
        for s, v in zip(state, (a, b, c, d, e, f, g, h))
    ]

    # Serialize back to big-endian bytes and route onto the final wires.
    out_wires = []
    for word in final:
        for byte_in_word in range(4):
            src = 3 - byte_in_word      # big-endian byte order
            out_wires.extend(word[8 * src + j] for j in range(8))
    return w.finish(out_wires, [256])


def sha256_pad(msg: bytes) -> list[bytes]:
    """Standard SHA-256 padding: the message as 64-byte blocks.  Chaining
    `sha256_compress` over them from `SHA256_IV` (each call's output state
    feeding the next call's state input — the formats match by construction)
    equals `hashlib.sha256(msg).digest()` for ANY length."""
    padded = msg + b"\x80"
    padded += b"\x00" * (-(len(padded) + 8) % 64)
    padded += struct.pack(">Q", 8 * len(msg))
    return [padded[i: i + 64] for i in range(0, len(padded), 64)]


def sha256_pad_one_block(msg: bytes) -> bytes:
    """Standard SHA-256 padding for messages that fit one 64-byte block
    (len <= 55).  One `sha256_compress` over `SHA256_IV` then equals
    `hashlib.sha256(msg).digest()`."""
    if len(msg) > 55:
        raise ValueError(f"message must fit one padded block (<=55 bytes), got {len(msg)}")
    return msg + b"\x80" + b"\x00" * (55 - len(msg)) + struct.pack(">Q", 8 * len(msg))


def _main() -> None:
    """Print the circuit as Bristol-Fashion text (``python -m
    csgn_tpu_torch.models.sha256 > sha256.txt``)."""
    import sys

    sys.stdout.write(sha256_compress().to_text())


if __name__ == "__main__":
    _main()
