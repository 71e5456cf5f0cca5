"""Packed-bit layout: MSB-first bit <-> 32-bit-word conversions, in torch.

The data contract is `csgn_tpu.layout`'s, kept exactly: a chunk of ``n``
plaintext-domain bits is stored as ``words32`` 32-bit words where bit ``j``
lives in word ``j // 32`` at shift ``31 - (j % 32)`` — the reference's
MSB-first uint64 packing (src/SecretKey.cpp:176-197) split into (hi, lo)
halves.  Ciphertexts are word-major ``[W, C]``.

Device tensors hold the words as ``torch.int32``, a bit-identical view of the
uint32 words (torch has no uint32 shifts, adds or ordered compares).  Crossing
from numpy is `words_from_numpy` (``a.view(np.int32)``), back is
`words_to_numpy` (``.view(np.uint32)``).  Because ``>>`` on int32 is
arithmetic, every right shift below is masked.

The host numpy helpers (`u64_to_u32`, `u32_to_u64`, `bit_positions_to_mask`,
`format_bits`) are `csgn_tpu.layout`'s, unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "words32_for",
    "pack_bits",
    "unpack_bits",
    "pack_bits_wc",
    "unpack_bits_wc",
    "words_from_numpy",
    "words_to_numpy",
    "u64_to_u32",
    "u32_to_u64",
    "bit_positions_to_mask",
    "format_bits",
]


def words32_for(n: int) -> int:
    """uint32 words per n-bit chunk: 2 * ceil(n / 64)."""
    return 2 * (-(-n // 64))


def _shifts(device) -> torch.Tensor:
    return torch.arange(31, -1, -1, dtype=torch.int64, device=device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack 0/1 values ``bits[..., n]`` into int32 words ``[..., words32]``.

    MSB-first within each word: bit j -> word j//32, shift 31 - (j%32).
    """
    n = bits.shape[-1]
    w32 = words32_for(n)
    b = torch.nn.functional.pad(bits.to(torch.int64) & 1, (0, w32 * 32 - n))
    b = b.reshape(*bits.shape[:-1], w32, 32)
    # Bits land in disjoint positions, so a sum is a bitwise OR; it is taken
    # in int64 and the [0, 2^32) result wraps to the int32 view.
    return (b << _shifts(b.device)).sum(dim=-1).to(torch.int32)


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Unpack int32 words ``[..., words32]`` into 0/1 uint8 ``[..., n]``."""
    bits = (words.to(torch.int64)[..., :, None] >> _shifts(words.device)) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32)[..., :n].to(torch.uint8)


def pack_bits_wc(bits: torch.Tensor) -> torch.Tensor:
    """Word-major packing: 0/1 values ``bits[..., n, C]`` -> int32 ``[..., W, C]``."""
    n, c = bits.shape[-2], bits.shape[-1]
    w32 = words32_for(n)
    b = torch.nn.functional.pad(bits.to(torch.int64) & 1, (0, 0, 0, w32 * 32 - n))
    b = b.reshape(*b.shape[:-2], w32, 32, c)
    return (b << _shifts(b.device)[:, None]).sum(dim=-2).to(torch.int32)


def unpack_bits_wc(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of `pack_bits_wc`: int32 ``[..., W, C]`` -> uint8 ``[..., n, C]``."""
    w = words.to(torch.int64)
    bits = (w[..., :, None, :] >> _shifts(words.device)[:, None]) & 1
    bits = bits.reshape(*w.shape[:-2], w.shape[-2] * 32, w.shape[-1])
    return bits[..., :n, :].to(torch.uint8)


def words_from_numpy(words_u32: np.ndarray, device="cpu") -> torch.Tensor:
    """uint32 numpy words -> int32 torch tensor on `device` (bit-identical).

    Always a copy: the tensor never aliases the caller's array, which may be
    read-only (a JAX array's host view)."""
    a = np.array(words_u32, dtype=np.uint32, order="C")
    return torch.from_numpy(a.view(np.int32)).to(device)


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 torch words (any device) -> uint32 numpy (bit-identical)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def u64_to_u32(words64: np.ndarray) -> np.ndarray:
    """Split uint64 words ``[..., W]`` into uint32 ``[..., 2W]`` (hi, lo) pairs
    (host-side: uint64 only appears at the serialization boundary)."""
    w = np.asarray(words64, dtype=np.uint64)
    out = np.empty(w.shape[:-1] + (w.shape[-1] * 2,), dtype=np.uint32)
    out[..., 0::2] = (w >> np.uint64(32)).astype(np.uint32)
    out[..., 1::2] = (w & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return out


def u32_to_u64(words32: np.ndarray) -> np.ndarray:
    """Inverse of `u64_to_u32`."""
    w = np.asarray(words32, dtype=np.uint32)
    assert w.shape[-1] % 2 == 0
    hi = w[..., 0::2].astype(np.uint64)
    lo = w[..., 1::2].astype(np.uint64)
    return (hi << np.uint64(32)) | lo


def bit_positions_to_mask(positions: np.ndarray, n: int) -> np.ndarray:
    """uint32[words32] mask with the given bit positions set (host-side)."""
    bits = np.zeros(n, dtype=np.uint32)
    bits[np.asarray(positions, dtype=np.int64)] = 1
    w32 = words32_for(n)
    pad = w32 * 32 - n
    b = np.pad(bits, (0, pad)).reshape(w32, 32)
    shifts = np.arange(31, -1, -1, dtype=np.uint32)
    return np.bitwise_or.reduce(b << shifts, axis=-1).astype(np.uint32)


def format_bits(words: np.ndarray, n: int) -> str:
    """Render a packed chunk (or chunks) as the reference's bit string.

    Mirrors the reference `operator<<` printing (src/Ciphertext.cpp:192-199):
    each chunk prints its n bits MSB-first, chunks concatenated.
    """
    w = np.asarray(words, dtype=np.uint32)
    if w.ndim == 1:
        w = w[None]
    out = []
    for chunk in w:
        j = np.arange(n)
        bits = (chunk[j // 32] >> (31 - (j % 32))) & 1
        out.append("".join("1" if b else "0" for b in bits))
    return "".join(out)
