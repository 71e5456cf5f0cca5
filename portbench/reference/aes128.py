"""Plain NumPy AES-128, table-based, per FIPS-197, over many blocks at once.

Written from the standard alone: the S-box is the multiplicative inverse in
GF(2^8) modulo x^8 + x^4 + x^3 + x + 1 (from exp and log tables of the
generator 0x03) followed by the affine map with the constant 0x63 (§5.1.1);
the key schedule is §5.2, the cipher §5.1.  Each function takes arrays of
blocks ``uint8[N, 16]`` in FIPS-197 input order.

The bit order of the benchmark's netlists: wire ``8 * i + j`` of a 128-bit
value is bit j (least significant first) of byte i (`to_bits`, `from_bits`).
"""

from __future__ import annotations

import numpy as np

__all__ = ["SBOX", "expand_key", "encrypt", "to_bits", "from_bits"]

_RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36)


def _xtime(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint16)
    return (((x << 1) ^ np.where(x & 0x80, 0x11B, 0)) & 0xFF).astype(np.uint8)


def _sbox() -> np.ndarray:
    exp = np.zeros(256, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i], log[x] = x, i
        x ^= int(_xtime(np.uint8(x)))  # x * 3 = x * 2 ^ x
    box = np.zeros(256, dtype=np.uint8)
    for v in range(256):
        b = 0 if v == 0 else int(exp[(255 - log[v]) % 255])
        s = b
        for r in range(1, 5):
            s ^= ((b << r) | (b >> (8 - r))) & 0xFF
        box[v] = s ^ 0x63
    return box


SBOX = _sbox()
_SHIFT_ROWS = np.array([(r + 4 * ((c + r) % 4)) for c in range(4) for r in range(4)])


def expand_key(keys: np.ndarray) -> np.ndarray:
    """The 11 round keys of each key: ``uint8[N, 16] -> uint8[N, 11, 16]``."""
    w = [keys[:, 4 * i:4 * i + 4] for i in range(4)]
    for i in range(4, 44):
        t = w[i - 1]
        if i % 4 == 0:
            t = SBOX[np.roll(t, -1, axis=1)]
            t = t ^ np.array([_RCON[i // 4 - 1], 0, 0, 0], dtype=np.uint8)
        w.append(w[i - 4] ^ t)
    return np.stack(w, axis=1).reshape(len(keys), 11, 16)


def _mix_columns(s: np.ndarray) -> np.ndarray:
    cols = s.reshape(len(s), 4, 4)  # [N, column, row]
    a0, a1, a2, a3 = (cols[:, :, r] for r in range(4))
    t = a0 ^ a1 ^ a2 ^ a3
    out = np.stack([a0 ^ t ^ _xtime(a0 ^ a1), a1 ^ t ^ _xtime(a1 ^ a2),
                    a2 ^ t ^ _xtime(a2 ^ a3), a3 ^ t ^ _xtime(a3 ^ a0)], axis=2)
    return out.reshape(len(s), 16)


def encrypt(keys: np.ndarray, blocks: np.ndarray, rounds: int = 10) -> np.ndarray:
    """AES-128 of each block under its own key: ``uint8[N, 16]`` each.

    ``rounds`` below 10 gives the reduced-round cipher (the check's control),
    which uses the first ``rounds + 1`` round keys of the same schedule.
    """
    keys = np.asarray(keys, dtype=np.uint8)
    s = np.asarray(blocks, dtype=np.uint8)
    rk = expand_key(keys)
    s = s ^ rk[:, 0]
    for r in range(1, rounds + 1):
        s = SBOX[s][:, _SHIFT_ROWS]
        if r < rounds:
            s = _mix_columns(s)
        s = s ^ rk[:, r]
    return s


def to_bits(values: np.ndarray) -> np.ndarray:
    """``uint8[..., k] -> uint8[..., 8k]``: bit j of byte i at 8 * i + j."""
    v = np.asarray(values, dtype=np.uint8)
    return ((v[..., :, None] >> np.arange(8, dtype=np.uint8)) & 1).reshape(*v.shape[:-1], -1)


def from_bits(bits: np.ndarray) -> np.ndarray:
    """Inverse of `to_bits`."""
    b = np.asarray(bits, dtype=np.uint8).reshape(*np.shape(bits)[:-1], -1, 8)
    return (b << np.arange(8, dtype=np.uint8)).sum(axis=-1).astype(np.uint8)
