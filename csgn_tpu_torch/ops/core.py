"""Core homomorphic ops on packed chunk tensors — plain torch oracles.

The semantics oracles of the port, counterparts of `csgn_tpu.ops.core`: every
CUDA kernel in `ops.kernels` must match them bit-exactly, and on CPU tensors
they are also the compute path.

Layout: word-major ``int32[W, C]`` (bit-identical to the JAX package's
``uint32[W, C]``); batched ciphertexts ``[B, W, C]`` broadcast over the
leading axis.

Semantics parity (reference certfhe/CSGN):
  * add = chunk concatenation            (reference src/Ciphertext.cpp:107-122)
  * mul = chunk cross-product AND, output chunk index i*t2 + j
                                         (reference src/Ciphertext.cpp:153-163)
  * decrypt = per-chunk AND over the d secret positions, parity across chunks
                                         (reference src/SecretKey.cpp:126-140)
"""

from __future__ import annotations

import torch

from csgn_tpu_torch import layout, rng

__all__ = ["add_chunks", "mul_chunks", "chunk_matches", "decrypt_parity", "permute_chunks",
           "keygen", "encrypt_bits_threefry_plain"]


def add_chunks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Homomorphic add: concatenate chunk axes.  [W,ta] + [W,tb] -> [W,ta+tb]."""
    return torch.cat([a, b], dim=-1)


def mul_chunks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Homomorphic multiply: chunk cross-product AND.

    [W,t1] * [W,t2] -> [W, t1*t2] with output chunk index ``i*t2 + j``
    (i-major, matching reference src/Ciphertext.cpp:159).
    """
    t1, t2 = a.shape[-1], b.shape[-1]
    out = a[..., :, None] & b[..., None, :]           # [..., W, t1, t2]
    return out.reshape(*out.shape[:-2], t1 * t2)


def chunk_matches(words: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-chunk decrypt bit: ``(chunk & mask) == mask`` on every word.

    words: int32[..., W, C]; mask: int32[W].  Returns int32[..., C] of 0/1.
    """
    m = mask[:, None]
    return ((words & m) == m).all(dim=-2).to(torch.int32)


def decrypt_parity(words: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Decrypt: parity (count mod 2) of the per-chunk match bits.

    Matches reference src/SecretKey.cpp:126-140.  Returns an int64 tensor
    with one bit per leading batch index (a 0-dim tensor for [W, C]).
    """
    return chunk_matches(words, mask).sum(dim=-1) & 1


def permute_chunks(words: torch.Tensor, perm: torch.Tensor, n: int) -> torch.Tensor:
    """Apply bit-position permutation per chunk: out bit i = in bit perm[i].

    words: int32[..., W, C] -> same shape; perm: int64 or int32 [n].  The
    gather oracle of the Beneš kernels (unpack -> row gather -> pack), as in
    `csgn_tpu.ops.core.permute_chunks` (reference src/Ciphertext.cpp:33-34).
    """
    bits = layout.unpack_bits_wc(words, n)
    out = torch.index_select(bits, -2, perm.to(device=words.device, dtype=torch.int64))
    return layout.pack_bits_wc(out)


def keygen(key: rng.Key, n: int, d: int) -> torch.Tensor:
    """Sample d distinct secret bit positions in [0, n) -> int32[d] (CPU).

    ``jax.random.permutation(key, n)[:d]``, bit for bit: the JAX package's
    `csgn_tpu.ops.core.keygen` (the same key gives the same indices, in the
    same order).
    """
    return torch.from_numpy(rng.permutation(key, n)[:d])


def encrypt_bits_threefry_plain(key: rng.Key, bits: torch.Tensor, key_idx: torch.Tensor,
                                mask: torch.Tensor, valid_mask: torch.Tensor, *,
                                col0: int = 0, total: int | None = None) -> torch.Tensor:
    """The JAX package's default encrypt engine (`csgn_tpu.ops.core.encrypt_bits`,
    "threefry") in plain torch, on any device: bits[batch] -> int32[W, batch],
    bit for bit.

    The batch is the columns ``[col0, col0 + batch)`` of an encrypt of
    `total` columns (default ``col0 + batch``), so a rank's slice of a
    sharded encrypt equals the one-device encrypt's columns.  With
    ``(k_words, k_rbit, k_ridx) = split(key, 3)``, column j's words are
    ``bits(k_words, (W, total))[:, j] & valid_mask``, its broken secret index
    is ``randint(k_ridx, (total,), 0, d)[j]`` and its coin
    ``bits(k_rbit, (total,))[j] & 1``; bit 1 ORs in the mask, bit 0 clears
    key[r]'s bit and sets it to the coin unless the other secret bits are
    all one (reference src/SecretKey.cpp:35-80).
    """
    w, d, batch = mask.shape[0], key_idx.shape[0], bits.shape[0]
    total = col0 + batch if total is None else int(total)
    dev = bits.device
    k_words, k_rbit, k_ridx = rng.split(key, 3)
    j = torch.arange(col0, col0 + batch, dtype=torch.int64, device=dev)
    rows = torch.arange(w, dtype=torch.int64, device=dev)[:, None]
    # The int64 -> int32 casts wrap [0, 2^32) onto the int32 view.
    words = rng.bits_flat(k_words, rows * total + j).to(torch.int32) & valid_mask[:, None]
    ones_words = words | mask[:, None]

    k1, k2 = rng.split(k_ridx)
    r = rng.randint_mod(d, rng.bits_flat(k1, j), rng.bits_flat(k2, j))
    r_pos = key_idx.to(torch.int64)[r]
    r_bit = (torch.ones_like(r_pos) << (31 - r_pos % 32)).to(torch.int32)
    onehot = torch.where(rows == (r_pos // 32)[None, :], r_bit[None, :], 0)
    mask_wo = mask[:, None] & ~onehot
    others_all_one = ((words & mask_wo) == mask_wo).all(dim=0)
    rand_bit = (rng.bits_flat(k_rbit, j) & 1) == 1
    forced = torch.where(rand_bit & ~others_all_one, onehot, 0)
    zero_words = (words & ~onehot) | forced
    is_one = ((bits.to(torch.int64) & 1) == 1)[None, :]
    return torch.where(is_one, ones_words, zero_words)
