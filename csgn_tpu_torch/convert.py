"""Carry state across from the JAX package, as numpy arrays.

`csgn_tpu` objects expose their state as host numpy (``SecretKey.indices``,
``np.asarray(Ciphertext.wt)`` as uint32 ``[W, C]``); these helpers build the
port's objects from it, bit-identically, without importing either JAX or
`csgn_tpu`.  Words cross as ``torch.from_numpy(a.view(np.int32))`` and come
back as ``.numpy().view(np.uint32)``; a netlist crosses as its Bristol text
(``Netlist.to_text()``).  ``device=None`` is the current CUDA device;
``device="cpu"`` runs on the CPU.  Whole files cross through `csgn_tpu_torch.io`,
which reads and writes the JAX package's ``.npz`` format.
"""

from __future__ import annotations

import numpy as np

from csgn_tpu_torch.batch import CiphertextBatch
from csgn_tpu_torch.ciphertext import Ciphertext
from csgn_tpu_torch.context import Context
from csgn_tpu_torch.layout import words_from_numpy, words_to_numpy
from csgn_tpu_torch.models.netlist import Netlist
from csgn_tpu_torch.permutation import Permutation
from csgn_tpu_torch.secret_key import SecretKey

__all__ = [
    "secret_key_from_numpy",
    "ciphertext_from_numpy",
    "ciphertext_batch_from_numpy",
    "permutation_from_numpy",
    "netlist_from_text",
    "words_from_numpy",
    "words_to_numpy",
]


def secret_key_from_numpy(ctx: Context, indices: np.ndarray, device=None) -> SecretKey:
    """The port's key over the same secret positions (e.g. ``sk.indices``)."""
    return SecretKey(ctx, np.asarray(indices), device)


def ciphertext_from_numpy(words_u32_wc: np.ndarray, ctx: Context, device=None) -> Ciphertext:
    """The port's ciphertext from word-major uint32 ``[W, C]`` words."""
    return Ciphertext(words_from_numpy(words_u32_wc, device), ctx)


def ciphertext_batch_from_numpy(words_u32_bwc: np.ndarray, ctx: Context,
                                device=None) -> CiphertextBatch:
    """The port's batch from uint32 ``[B, W, C]`` words (``np.asarray(cb.wt)``)."""
    return CiphertextBatch(words_from_numpy(words_u32_bwc, device), ctx)


def permutation_from_numpy(perm: np.ndarray) -> Permutation:
    """The port's permutation of the same array (e.g. ``p.perm``)."""
    return Permutation(np.asarray(perm))


def netlist_from_text(text: str) -> Netlist:
    """The port's netlist of the same gates (e.g. a JAX ``Netlist.to_text()``)."""
    return Netlist.parse(text)
