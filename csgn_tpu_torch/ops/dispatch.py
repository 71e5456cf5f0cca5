"""Op dispatch: multiply, decrypt and permute, single and batched.

The JAX package routes by backend, size and lane alignment (flat / tiled /
grouped / ragged / j-major kernels, `MUL_PALLAS_MIN_OUT`) because Mosaic
needs 128-lane-aligned blocks and VMEM-resident operands.  Here a CPU
tensor goes to the plain torch version and a CUDA tensor to the kernel;
which route served each call is counted in `op_metrics()` as
``dispatch.<op>.<cuda|plain>``.  On the card the multiply then picks one of
csrc/mul.cu's modes from the shapes (`kernels.mul_mode`, counted as
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
  ``*.jm_flat``, ``*.jm_tiled``, ``*.jm_ragged``,         the mode of the shape
  ``*.jm_xla`` (j-major: operands swapped, order tag)     (canonical order)
  ``mul.xla``, ``mul_dec.xla``, ``*.b_xla``               the mode of the shape
  ======================================================  ===================

The canonical functions (`mul_chunks`, `mul_decrypt`, `mul_decrypt_count`,
`mul_decrypt_batched`) always write the reference's i-major order.  The
``*_auto`` functions and `mul_chunks_batched` serve callers that carry an
order tag (`ops.order`): they return JAX's tuples ``(words, jmajor, zpad_a,
zpad_b[, parity])``.  On the card and on the CPU they write the canonical
order with no pad chunks (the JAX package likewise routes only on its TPU
backend, so both packages give the same words on the CPU).  A j-major
product is made only on request (`mul_chunks_jmajor`): on an H100 the
swapped operands at 16 x 2^19 took 0.04 ms less than the tiled mode, but a
consumer that needs canonical order then pays a 5 ms gather (PERF.md).
The permutations run the Beneš kernels of `ops.benes_kernels` at every
size.
"""

from __future__ import annotations

import torch

from csgn_tpu_torch.ops import benes_kernels, kernels
from csgn_tpu_torch.utils.metrics import op_metrics

__all__ = [
    "mul_chunks",
    "mul_chunks_auto",
    "mul_chunks_jmajor",
    "mul_decrypt",
    "mul_decrypt_auto",
    "mul_decrypt_batched_auto",
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


def mul_chunks_jmajor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[W,t1] x [W,t2] -> [W, t1*t2] in **j-major** physical order (column
    p = j*t1 + i holds a_i & b_j): the canonical product of the swapped
    operands, one launch of csrc/mul.cu in the mode `kernels.mul_mode` picks
    for (t2, t1).  Batched [B,W,*] operands likewise."""
    _path("mul_jm", a)
    return kernels.mul_chunks(b, a)


def mul_chunks_auto(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, bool, int, int]:
    """The product with its order: ``(words, jmajor, zpad_a, zpad_b)`` (the
    JAX package's tuple).  The port's route is canonical with no pad chunks:
    ``(mul_chunks(a, b), False, 0, 0)``."""
    _path("mul", a)
    return kernels.mul_chunks(a, b), False, 0, 0


def mul_decrypt_auto(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor):
    """Fused multiply + decrypt on `mul_chunks_auto`'s route: ``(words,
    jmajor, zpad_a, zpad_b, parity)``.  The parity is a reduction over the
    multiset of product chunks (reference src/SecretKey.cpp:126-140), the
    same in either chunk order."""
    _path("mul_dec", a)
    out, parity = kernels.mul_decrypt(a, b, mask)
    return out, False, 0, 0, parity


def mul_chunks_batched(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, bool, int, int]:
    """Batched `mul_chunks_auto`: [B,W,t1] x [B,W,t2] -> ``([B,W,phys],
    jmajor, zpad_a, zpad_b)``, element i the cross product of the operands'
    elements i, every element in one physical order (one launch for the
    batch; the route is the per-element shape's)."""
    _path("mul_batched", a)
    return kernels.mul_chunks(a, b), False, 0, 0


def mul_decrypt_batched_auto(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor):
    """Batched fused multiply + decrypt on `mul_chunks_batched`'s route:
    ``(words [B,W,phys], jmajor, zpad_a, zpad_b, parity int64[B])``."""
    _path("mul_dec_batched", a)
    out, parity = kernels.mul_decrypt(a, b, mask)
    return out, False, 0, 0, parity


def mul_decrypt_batched(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor):
    """Batched fused multiply + decrypt in canonical order: ``(prod
    [B,W,t1*t2] i-major, parity int64[B])``; callers that carry an order tag
    use `mul_decrypt_batched_auto`."""
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
