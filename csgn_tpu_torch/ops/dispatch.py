"""Op dispatch: multiply, decrypt and permute, single and batched.

The JAX package routes by backend, size and lane alignment (flat / tiled /
grouped / ragged / j-major kernels, `MUL_PALLAS_MIN_OUT`) because Mosaic
needs 128-lane-aligned blocks and VMEM-resident operands.  The CUDA multiply
writes the canonical i-major product for any shape, so here the route is the
device alone: a CUDA tensor goes to the kernel, a CPU tensor to the plain
torch version.  Which route served each call is counted in `op_metrics()`
as ``dispatch.<op>.<cuda|plain>``; on the card the multiply then picks one
of csrc/mul.cu's modes from the shapes (`kernels.mul_mode`, counted as
``<wrapper>.<mode>``).  The JAX route names map onto those modes:

  ======================================================  ===================
  JAX route (csgn_tpu/ops/dispatch.py `_path`)            CUDA mode
  ======================================================  ===================
  ``mul.flat``, ``mul_dec.flat``, ``*.b_flat``            aligned (K1/K2)
  ``mul.tiled``, ``mul_dec.tiled``, ``*.b_tiled``         tiled (b > 25 MB) or
                                                          aligned
  ``mul.grouped``, ``mul_dec.grouped``                    unaligned
  ``mul.ragged``, ``mul_dec.ragged``, ``*.b_ragged``      unaligned (no pads),
                                                          tiled for a large b
  ``*.jm_flat``, ``*.jm_tiled``, ``*.jm_ragged``,         the canonical mode
  ``*.jm_xla`` (j-major: operands swapped, order tag)     of the same shape
  ``mul.xla``, ``mul_dec.xla``, ``*.b_xla``               the mode of the shape
  ======================================================  ===================

There are no ``*_auto`` or ``mul_chunks_jmajor`` counterparts: every product
is canonical, with exactly t1*t2 chunks.

Batched ops take ``[B, W, C]`` words and always return canonical i-major
order with no pad chunks (the JAX package's `mul_chunks_batched` may return
j-major or padded products with an order tag; the port never does), so
`CiphertextBatch` needs no tag.  The permutations run the Beneš kernels of
`ops.benes_kernels` at every size (the JAX package switches to Pallas from
`BENES_PALLAS_MIN_C` chunks; the CUDA kernel has no such threshold).
"""

from __future__ import annotations

import torch

from csgn_tpu_torch.ops import benes_kernels, kernels
from csgn_tpu_torch.utils.metrics import op_metrics

__all__ = [
    "mul_chunks",
    "mul_decrypt",
    "mul_decrypt_count",
    "decrypt_parity",
    "decrypt_count",
    "chunk_matches",
    "mul_chunks_batched",
    "mul_decrypt_batched",
    "permute",
    "permute_batched",
    "permute_batched_multi",
    "permute_decrypt",
]


def _path(op: str, t: torch.Tensor) -> None:
    op_metrics().count(f"dispatch.{op}.{'cuda' if t.is_cuda else 'plain'}")


def mul_chunks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[W,t1] x [W,t2] -> [W,t1*t2] in canonical i-major order."""
    _path("mul", a)
    return kernels.mul_chunks(a, b)


def mul_decrypt(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor):
    """Fused multiply + decrypt: ``(prod [W, t1*t2] i-major, parity)``.
    Bit-exact to ``decrypt_parity(mul_chunks(a, b), mask)``."""
    _path("mul_dec", a)
    return kernels.mul_decrypt(a, b, mask)


def mul_decrypt_count(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor):
    """`mul_decrypt` with the exact int64 match count in place of the parity
    (the summable form a sharded product needs before the final mod 2)."""
    _path("mul_dec", a)
    return kernels.mul_decrypt(a, b, mask, return_count=True)


def decrypt_parity(words: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Parity of the per-chunk match bits of [W, C] (int64 0-dim tensor), or
    of each element of a batch [B, W, C] (int64[B])."""
    _path("decrypt", words)
    return kernels.decrypt_parity(words, mask)


def decrypt_count(words: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The exact int64 match count of [W, C] (0-dim), or of each element of a
    batch [B, W, C] (int64[B]): `decrypt_parity` before the mod 2, the
    summable form a sharded decrypt reduces across ranks (K3)."""
    _path("decrypt", words)
    return kernels.decrypt_parity(words, mask, return_count=True)


def chunk_matches(words: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-chunk match bits of [W, C] -> int32[C]."""
    _path("chunk_matches", words)
    return kernels.chunk_matches(words, mask)


def mul_chunks_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B,W,t1] x [B,W,t2] -> [B,W,t1*t2]: element i is the canonical cross
    product of the operands' elements i (one launch for the batch)."""
    _path("mul_batched", a)
    return kernels.mul_chunks(a, b)


def mul_decrypt_batched(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor):
    """Batched fused multiply + decrypt: ``(prod [B,W,t1*t2], parity int64[B])``.
    Bit-exact to ``decrypt_parity(mul_chunks_batched(a, b), mask)``."""
    _path("mul_dec_batched", a)
    return kernels.mul_decrypt(a, b, mask)


def permute(words: torch.Tensor, plan) -> torch.Tensor:
    """Beneš permutation of [W, C] (K8)."""
    _path("permute", words)
    return benes_kernels.apply_benes(words, plan)


def permute_batched(words: torch.Tensor, plan) -> torch.Tensor:
    """One Beneš plan over every element of [B, W, C]: K8 with a batch grid,
    where the JAX package vmaps its K8.  The body is `permute`'s; the name
    and the route label mirror the JAX package's dispatch."""
    _path("permute_batched", words)
    return benes_kernels.apply_benes(words, plan)


def permute_batched_multi(words: torch.Tensor, stacked) -> torch.Tensor:
    """k DIFFERENT permutations over k ciphertexts [k, W, C] (K9): plan i's
    masks are selected by the batch index — the key-rotation-fleet pattern."""
    _path("permute_batched_multi", words)
    return benes_kernels.apply_benes_batch(words, stacked)


def permute_decrypt(words: torch.Tensor, plan, mask: torch.Tensor):
    """Permutation + decrypt: ``(permuted [W, C], parity)``.

    `mask` must be the key matching the OUTPUT (the permuted key's mask).
    Staged — K8 then K3 — as the JAX package keeps it
    (csgn_tpu/ops/dispatch.py:533-559).  The one-pass kernel K12 stays
    available as `benes_kernels.apply_benes_decrypt`, as it does there;
    both are bit-exact.
    """
    _path("permute_dec", words)
    out = benes_kernels.apply_benes(words, plan)
    return out, kernels.decrypt_parity(out, mask)
