"""AES-128 as a Bristol-Fashion netlist — the published suite's flagship.

The MPC/FHE benchmark suite's headline circuit is AES-128(key, block); the
reference framework has nothing at this scale (its tests hand-chain a couple
of gates, reference tests/basic_operations.cpp:30-43).  This module
generates the FULL cipher — key expansion + 10 rounds — in the {XOR, AND,
INV} basis as a `Netlist`, so it runs through every evaluation path the
netlist layer offers (`eval_plain`, `eval_expr` + `SecretKey.
decrypt_circuits`, batched fleets).  Verified against the FIPS-197 worked
examples (Appendix B and C.1) and a table-based oracle in tests/test_aes.py.

Construction notes
------------------
* S-box: GF(2^8) inversion as x^254 (square-and-multiply: 4 field
  multiplications + 7 squarings, reduction mod x^8+x^4+x^3+x+1) followed by
  the standard affine map (constant 0x63 as INV gates).  This is the same
  algebraic construction as the committed `tests/circuits/aes_sbox.txt`
  fixture — not the Boyar–Peralta gate-minimized netlist, so the circuit is
  larger than the published aes_128 file (~1000 vs ~113 gates per S-box) but
  independently authored and in the same format/interface class.
* MixColumns / ShiftRows / AddRoundKey are pure XOR + rewiring; xtime is
  3 XORs (conditional 0x1b fold-in).
* Growth: 200 S-box instances × 256 AND gates = 51,200 ANDs, AND-depth ≈ 40;
  materialized chunk growth is astronomically superlinear, so homomorphic
  evaluation goes through the growth-free `eval_expr` path and key-side
  `decrypt_circuits` (Dec is a ring homomorphism onto F2 — reference
  src/SecretKey.cpp:126-146).

Bit conventions (documented, since the published files' orderings are
notoriously implicit): two input values [key(128), block(128)], one output
value [128].  Wire ``8*i + j`` of a value is bit ``j`` (LSB-first) of byte
``i``, bytes in FIPS-197 input order (byte 0 = first byte of the key /
plaintext hex string; state column-major per §3.4).
"""

from __future__ import annotations

from csgn_tpu_torch.models.netlist import Netlist, _Builder

__all__ = ["aes128", "AES_RCON"]

AES_RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36)

_Byte = list  # 8 wire ids, LSB-first
_W = _Builder  # the shared wire allocator (netlist.py) — helpers below take one


def _xor_byte(w: _W, x: _Byte, y: _Byte) -> _Byte:
    return [w.xor(x[i], y[i]) for i in range(8)]


def _xor_const(w: _W, x: _Byte, c: int) -> _Byte:
    return [w.inv(x[i]) if (c >> i) & 1 else x[i] for i in range(8)]


def _xtime(w: _W, a: _Byte) -> _Byte:
    """Multiply by x in GF(2^8): shift left, fold 0x1b under the high bit."""
    hi = a[7]
    return [hi, w.xor(a[0], hi), a[1], w.xor(a[2], hi),
            w.xor(a[3], hi), a[4], a[5], a[6]]


def _reduce15(coeffs: list[list[int]]) -> list[list[int]]:
    """Reduce degree-14 coefficient wire-lists mod x^8 + x^4 + x^3 + x + 1."""
    c = [list(ws) for ws in coeffs]
    for k in range(14, 7, -1):
        for tgt in (k - 4, k - 5, k - 7, k - 8):
            c[tgt].extend(c[k])
        c[k] = []
    return c[:8]


def _gf_mul(w: _W, a: _Byte, b: _Byte) -> _Byte:
    prods: list[list[int]] = [[] for _ in range(15)]
    for i in range(8):
        for j in range(8):
            prods[i + j].append(w.and_(a[i], b[j]))
    return [w.xor_tree(ws) for ws in _reduce15(prods)]


def _gf_sq(w: _W, a: _Byte) -> _Byte:
    coeffs: list[list[int]] = [[] for _ in range(15)]
    for i in range(8):
        coeffs[2 * i].append(a[i])
    reduced = _reduce15(coeffs)
    # Squaring is linear over GF(2); every reduced coefficient list is
    # non-empty for this modulus (each of bits 1,3,5,7 receives at least one
    # folded high term), so no constant-zero wires are needed.
    assert all(reduced), "empty coefficient after reduction"
    return [w.xor_tree(ws) for ws in reduced]


def _sbox(w: _W, x: _Byte) -> _Byte:
    """S(x) = affine(x^254): inversion with 0 -> 0 falling out of x^254."""
    t2 = _gf_sq(w, x)                                   # x^2
    t3 = _gf_mul(w, t2, x)                              # x^3
    t12 = _gf_sq(w, _gf_sq(w, t3))                      # x^12
    t15 = _gf_mul(w, t12, t3)                           # x^15
    t240 = _gf_sq(w, _gf_sq(w, _gf_sq(w, _gf_sq(w, t15))))  # x^240
    t252 = _gf_mul(w, t240, t12)                        # x^252
    inv = _gf_mul(w, t252, t2)                          # x^254 = x^-1
    out = [
        w.xor_tree([inv[i], inv[(i + 4) % 8], inv[(i + 5) % 8],
                    inv[(i + 6) % 8], inv[(i + 7) % 8]])
        for i in range(8)
    ]
    return _xor_const(w, out, 0x63)


def _mix_column(w: _W, col: list[_Byte]) -> list[_Byte]:
    """[2 3 1 1; 1 2 3 1; 1 1 2 3; 3 1 1 2] · col over GF(2^8)."""
    xt = [_xtime(w, b) for b in col]
    x3 = [_xor_byte(w, xt[i], col[i]) for i in range(4)]  # 3·b = xtime(b)^b
    out = []
    for r in range(4):
        terms = [xt[r], x3[(r + 1) % 4], col[(r + 2) % 4], col[(r + 3) % 4]]
        acc = terms[0]
        for t in terms[1:]:
            acc = _xor_byte(w, acc, t)
        out.append(acc)
    return out


def aes128() -> Netlist:
    """Build the AES-128 encryption netlist: [key(128), block(128)] -> [128].

    ~229k gates (51,200 AND across 200 S-box instances); construction takes
    ~2 s, one `eval_plain` ~0.1 s.  See the module docstring for bit
    conventions and verification anchors.
    """
    w = _W([128, 128])
    key_bytes: list[_Byte] = [[8 * i + j for j in range(8)] for i in range(16)]
    pt_bytes: list[_Byte] = [
        [128 + 8 * i + j for j in range(8)] for i in range(16)
    ]

    # Key expansion (FIPS-197 §5.2): words are 4 bytes, w[i][k] = byte k.
    words: list[list[_Byte]] = [key_bytes[4 * i: 4 * i + 4] for i in range(4)]
    for i in range(4, 44):
        temp = words[i - 1]
        if i % 4 == 0:
            rot = [temp[1], temp[2], temp[3], temp[0]]
            sub = [_sbox(w, b) for b in rot]
            sub[0] = _xor_const(w, sub[0], AES_RCON[i // 4 - 1])
            temp = sub
        words.append([_xor_byte(w, words[i - 4][k], temp[k]) for k in range(4)])

    # State bytes in FIPS input order: state[r][c] = bytes[r + 4c] (§3.4).
    state = [_xor_byte(w, pt_bytes[j], words[j // 4][j % 4]) for j in range(16)]

    for rnd in range(1, 11):
        state = [_sbox(w, b) for b in state]                     # SubBytes
        # ShiftRows: row r rotates left by r; byte index j = r + 4c.
        state = [state[(j % 4) + 4 * ((j // 4 + j % 4) % 4)] for j in range(16)]
        if rnd < 10:                                             # MixColumns
            mixed: list[_Byte] = []
            for c in range(4):
                mixed.extend(_mix_column(w, state[4 * c: 4 * c + 4]))
            state = mixed
        state = [
            _xor_byte(w, state[j], words[4 * rnd + j // 4][j % 4])
            for j in range(16)
        ]

    # Route the 128 output bits onto the final wire block (EQW copies).
    return w.finish([b[j] for b in state for j in range(8)], [128])


def _main() -> None:
    """Print the circuit as Bristol-Fashion text (``python -m
    csgn_tpu_torch.models.aes > aes128.txt``)."""
    import sys

    sys.stdout.write(aes128().to_text())


if __name__ == "__main__":
    _main()
