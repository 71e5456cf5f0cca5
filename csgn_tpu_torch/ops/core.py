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

from csgn_tpu_torch import layout

__all__ = ["add_chunks", "mul_chunks", "chunk_matches", "decrypt_parity", "permute_chunks",
           "keygen"]


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


def keygen(n: int, d: int, generator: torch.Generator) -> torch.Tensor:
    """Sample d distinct secret bit positions in [0, n) -> int32[d] (CPU).

    The first d entries of a uniform permutation, as `csgn_tpu.ops.core.keygen`
    does with `jax.random.permutation`; the two generators give different
    keys from the same seed, so tests hand both packages the same indices.
    """
    return torch.randperm(n, generator=generator)[:d].to(torch.int32)
