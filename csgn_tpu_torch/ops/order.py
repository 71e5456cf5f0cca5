"""Lazy chunk-order tags: the physical chunk layout apart from the reference
order.

Counterpart of `csgn_tpu.ops.order`.  Decryption is a parity over the
*multiset* of chunks (reference src/SecretKey.cpp:126-140), so the order of
the chunks inside a ciphertext does not matter to any homomorphic operator;
only the reference's observable byte layout (serialization, printing, golden
comparisons) pins the canonical order ``i*t2 + j`` of a product
(src/Ciphertext.cpp:159) and "left then right" of a sum
(src/Ciphertext.cpp:107-122).  A product may therefore be written in
whatever order its kernel likes, with a **logical index tag**:

    logical: int32[physical]          # physical position p holds the chunk
                                      # whose reference-order index is
                                      # logical[p], or PAD (-1) for an
                                      # all-zero pad chunk
    None                              # identity: physical == canonical

**Pad chunks**: an all-zero chunk is parity-neutral under decryption ((0 &
mask) != mask) and absorbing under multiply (0 & x = 0), so a route may
append zero chunks to an operand.  They are marked PAD and dropped, with the
order, by the one gather at the interop boundaries (`canonicalize`).

Tags are int32 tensors on the payload's device; every function keeps them
there.  The ``device`` argument is where a tag is made when every input tag
is None (identity); it defaults to the current CUDA device.
"""

from __future__ import annotations

import torch

from csgn_tpu_torch._device import resolve_device

__all__ = [
    "PAD",
    "concat_logical",
    "cross_logical",
    "extend_with_pads",
    "canonicalize",
    "inverse_permutation",
]

# Tag value marking an all-zero pad chunk (no reference-order index).
PAD = -1


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _device(tags, device) -> torch.device:
    for t in tags:
        if t is not None:
            return t.device
    return resolve_device(device)


def extend_with_pads(tag: torch.Tensor | None, n: int, zpad: int,
                     device=None) -> torch.Tensor | None:
    """Tag for a payload extended with ``zpad`` zero chunks (identity if 0)."""
    if zpad == 0:
        return tag
    dev = _device((tag,), device)
    base = tag if tag is not None else _iota(n, dev)
    return torch.cat([base, torch.full((zpad,), PAD, dtype=torch.int32, device=dev)])


def concat_logical(la: torch.Tensor | None, lb: torch.Tensor | None, t1: int, t2: int,
                   device=None) -> torch.Tensor | None:
    """Order tag for add = [a ; b]: b's logical indices shift by a's
    **logical** chunk count ``t1`` (pads keep PAD)."""
    if la is None and lb is None:
        return None
    dev = _device((la, lb), device)
    ia = la if la is not None else _iota(t1, dev)
    ib = lb if lb is not None else _iota(t2, dev)
    ib = torch.where(ib >= 0, ib + t1, ib)
    return torch.cat([ia, ib])


def cross_logical(la: torch.Tensor | None, lb: torch.Tensor | None, t1: int, t2: int, *,
                  jmajor: bool, device=None) -> torch.Tensor | None:
    """Order tag for a physical chunk cross-product.

    ``t1``/``t2`` are the operands' **logical** chunk counts; physical counts
    come from the tags (equal to logical when a tag is None).  The logical
    index of the product of a's chunk (logical i) with b's chunk (logical j)
    is ``i*t2 + j`` (reference src/Ciphertext.cpp:159); a pair with a pad
    chunk is a pad.  The physical layout is i-major (canonical,
    ``p = p1*t2P + p2``) or j-major (``p = p2*t1P + p1``: the canonical
    product of the swapped operands).
    """
    if la is None and lb is None and not jmajor:
        return None
    dev = _device((la, lb), device)
    if la is None and lb is None:
        # Untagged operands have no pads: one broadcast add writes the tag.
        return (_iota(t2, dev)[:, None] + _iota(t1, dev)[None, :] * t2).reshape(-1)
    ia = la if la is not None else _iota(t1, dev)
    ib = lb if lb is not None else _iota(t2, dev)
    if jmajor:
        grid = ib[:, None] + ia[None, :] * t2
        pad = (ib[:, None] < 0) | (ia[None, :] < 0)
    else:
        grid = ia[:, None] * t2 + ib[None, :]
        pad = (ia[:, None] < 0) | (ib[None, :] < 0)
    return torch.where(pad, PAD, grid).to(torch.int32).reshape(-1)


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """inv with inv[perm[p]] = p (perm must be a permutation of [0, C))."""
    c = perm.shape[0]
    inv = torch.zeros(c, dtype=torch.int32, device=perm.device)
    inv[perm.long()] = _iota(c, perm.device)
    return inv


def canonicalize(words: torch.Tensor, logical: torch.Tensor,
                 out_len: int | None = None) -> torch.Tensor:
    """Reorder payload columns into canonical order, dropping pad chunks:
    ``out[..., logical[p]] = in[..., p]`` for every p with ``logical[p] >= 0``.

    ``out_len`` is the logical chunk count (physical count minus pads); pass
    it whenever pads are present.  One gather over the chunk axis on the
    payload's device (`torch.index_select`; the JAX package's is XLA's
    `take`).  A slot that no physical column fills (only a corrupted tag:
    the non-pad entries must be a permutation of [0, out_len)) decodes to an
    all-ones column, which fails the canonical-form check
    (`utils.checks`), as in the JAX package.
    """
    phys = logical.shape[0]
    if out_len is None:
        out_len = phys
    # Physical positions scattered to their logical slots; pads go to the
    # extra slot out_len, which is cut off.
    slots = torch.where(logical >= 0, logical, out_len).long()
    inv = torch.full((out_len + 1,), phys, dtype=torch.long, device=logical.device)
    inv.scatter_(0, slots, torch.arange(phys, device=logical.device))
    inv = inv[:out_len]
    out = torch.index_select(words, -1, inv.clamp(max=max(phys - 1, 0)))
    # A mask fill, not a test of the mask: no host synchronization.
    return out.masked_fill_(inv == phys, -1)
