"""Op dispatch for the multiply and decrypt half of the slice.

The JAX package routes by backend, size and lane alignment (flat / tiled /
grouped / ragged / j-major kernels, `MUL_PALLAS_MIN_OUT`) because Mosaic
needs 128-lane-aligned blocks and VMEM-resident operands.  The CUDA kernels
write the canonical i-major product for any shape, so here the route is the
device alone: a CUDA tensor goes to the kernel, a CPU tensor to the plain
torch version.  Which route served each call is counted in `op_metrics()`
as ``dispatch.<op>.<cuda|plain>``.
"""

from __future__ import annotations

import torch

from csgn_tpu_torch.ops import kernels
from csgn_tpu_torch.utils.metrics import op_metrics

__all__ = [
    "mul_chunks",
    "mul_decrypt",
    "mul_decrypt_count",
    "decrypt_parity",
    "chunk_matches",
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
    """Parity of the per-chunk match bits of [W, C] (int64 0-dim tensor)."""
    _path("decrypt", words)
    return kernels.decrypt_parity(words, mask)


def chunk_matches(words: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-chunk match bits of [W, C] -> int32[C]."""
    _path("chunk_matches", words)
    return kernels.chunk_matches(words, mask)
