"""Permutation as a one-hot matrix product — a second implementation beside
the Beneš kernels.

Counterpart of `csgn_tpu.ops.permute_mxu`.  A bit-position permutation is a
linear map over GF(2): unpack the chunks to an ``[n_pad, C]`` bit matrix,
multiply by the one-hot permutation matrix in bf16 (0/1 values are exact),
pack again.  The JAX package's product is XLA's ``dot_general`` on the MXU,
not a Pallas kernel; here it is `torch.matmul` in bf16 (the card's tensor
cores on a CUDA tensor).  It serves as an independent check of the Beneš
kernels (`ops.benes_kernels`), not as a route of `Ciphertext`.

Memory: the bit matrix is ``n_pad * C * 2`` bytes (2.7 GB at n = 1247 over
2^20 chunks) beside the product's as many, so size C to the device.
"""

from __future__ import annotations

import numpy as np
import torch

from csgn_tpu_torch._device import resolve_device

__all__ = ["onehot_matrix", "permute_chunks_mxu"]


def _pad128(n: int) -> int:
    return -(-n // 128) * 128


def onehot_matrix(perm: np.ndarray, n: int, device=None) -> torch.Tensor:
    """bf16 one-hot matrix P with P[i, perm[i]] = 1, padded to 128-multiples,
    on `device` (None = the current CUDA device)."""
    n_pad = _pad128(n)
    p = torch.zeros((n_pad, n_pad), dtype=torch.bfloat16, device=resolve_device(device))
    rows = torch.arange(n, device=p.device)
    cols = torch.from_numpy(np.asarray(perm, dtype=np.int64)).to(p.device)
    p[rows, cols] = 1
    return p


def permute_chunks_mxu(words: torch.Tensor, p_onehot: torch.Tensor, n: int) -> torch.Tensor:
    """Apply a permutation by the one-hot product: int32[..., W, C] -> same
    shape.

    `p_onehot` from `onehot_matrix`.  Bit-exact to `core.permute_chunks`:
    the values stay in {0, 1}, which bf16 holds exactly, and each output
    has at most one nonzero term.  Bits at positions >= n of the input meet
    only zero columns of P, and the output's are zero, as in the JAX
    package's unpack to n rows.
    """
    n_pad = p_onehot.shape[0]
    *lead, w, c = words.shape
    # The bit matrix, row j = bit j (MSB first in word j // 32), built one
    # shift at a time so that no int64 temporary of the whole matrix exists.
    bits = torch.zeros((*lead, n_pad, c), dtype=torch.bfloat16, device=words.device)
    view = bits[..., : 32 * w, :].unflatten(-2, (w, 32))
    for k in range(32):
        view[..., k, :] = (words >> (31 - k)) & 1
    out = torch.matmul(p_onehot, bits)[..., : 32 * w, :].unflatten(-2, (w, 32))
    packed = torch.zeros_like(words)
    for k in range(32):
        packed |= out[..., k, :].to(torch.int32) << (31 - k)
    return packed
