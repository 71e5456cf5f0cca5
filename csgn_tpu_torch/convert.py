"""Carry state across from the JAX package, as numpy arrays.

`csgn_tpu` objects expose their state as host numpy (``SecretKey.indices``,
``np.asarray(Ciphertext.wt)`` as uint32 ``[W, C]``); these helpers build the
port's objects from it, bit-identically, without importing either JAX or
`csgn_tpu`.  Words cross as ``torch.from_numpy(a.view(np.int32))`` and come
back as ``.numpy().view(np.uint32)``.
"""

from __future__ import annotations

import numpy as np

from csgn_tpu_torch.ciphertext import Ciphertext
from csgn_tpu_torch.context import Context
from csgn_tpu_torch.layout import words_from_numpy, words_to_numpy
from csgn_tpu_torch.secret_key import SecretKey

__all__ = [
    "secret_key_from_numpy",
    "ciphertext_from_numpy",
    "words_from_numpy",
    "words_to_numpy",
]


def secret_key_from_numpy(ctx: Context, indices: np.ndarray, device="cpu") -> SecretKey:
    """The port's key over the same secret positions (e.g. ``sk.indices``)."""
    return SecretKey(ctx, np.asarray(indices), device)


def ciphertext_from_numpy(words_u32_wc: np.ndarray, ctx: Context, device="cpu") -> Ciphertext:
    """The port's ciphertext from word-major uint32 ``[W, C]`` words."""
    return Ciphertext(words_from_numpy(words_u32_wc, device), ctx)
