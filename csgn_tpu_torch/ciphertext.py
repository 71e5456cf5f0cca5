"""Ciphertext: an immutable packed chunk tensor on a CPU or CUDA device.

Counterpart of `csgn_tpu.ciphertext.Ciphertext` (reference
`certFHE::Ciphertext`, src/Ciphertext.{h,cpp}):

  * **Immutable** — every operator returns a fresh `Ciphertext` (the
    reference's mutable value semantics harbor a use-after-free,
    src/Ciphertext.cpp:306-329; SURVEY.md §2b.1).
  * **Word-major int32 storage** — ``wt: int32[W, chunks]``, W = ctx.words32,
    bit-identical to the JAX package's ``uint32[W, chunks]`` (see
    `csgn_tpu_torch.layout`).  Chunk-major views exist only at the
    serialization boundary (`to_u64`/`from_u64`).
  * **Always canonical** — the CUDA multiply writes the reference's i-major
    ``i*t2+j`` order (src/Ciphertext.cpp:159) for any t2, so products carry no
    order tag and no pad chunks; `canonical()` returns ``self``.
  * **No materialized bitlen** — derived from the context when needed.

Operators: ``+`` concatenates chunks, ``*`` is the chunk cross-product AND —
semantics parity with reference src/Ciphertext.cpp:107-179.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from csgn_tpu_torch import layout
from csgn_tpu_torch.context import Context
from csgn_tpu_torch.ops import core, dispatch
from csgn_tpu_torch.utils.metrics import op_metrics

__all__ = ["Ciphertext"]


@dataclasses.dataclass(frozen=True, eq=False)
class Ciphertext:
    """Packed ciphertext words ``int32[W, chunks]`` plus its context.

    ``eq=False``: tensor fields have no boolean ``==``; compare ``wt`` or
    ``to_u64()`` explicitly."""

    wt: torch.Tensor
    ctx: Context

    def __post_init__(self):
        w = self.wt
        if not isinstance(w, torch.Tensor) or w.dtype != torch.int32:
            raise TypeError("ciphertext words must be an int32 torch.Tensor")
        if w.dim() != 2 or w.shape[0] != self.ctx.words32:
            raise ValueError(
                f"ciphertext words must be [W={self.ctx.words32}, chunks], got shape "
                f"{tuple(w.shape)}"
            )

    # -- properties ---------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.wt.device

    @property
    def chunks(self) -> int:
        return int(self.wt.shape[-1])

    @property
    def nbytes(self) -> int:
        """Payload bytes (packed)."""
        return self.ctx.chunk_count_bytes(self.chunks)

    def size(self) -> int:
        """Reference byte accounting (src/Ciphertext.cpp:91-101): 352 B for a
        fresh Context(1247,16) ciphertext.  Device payload bytes are `nbytes`."""
        return 32 + 16 * self.chunks * self.ctx.words64

    @property
    def bitlen(self) -> tuple[int, ...]:
        """Per-uint64-word occupied bit counts, whole ciphertext."""
        return self.ctx.bitlen * self.chunks

    # -- homomorphic operators ---------------------------------------------

    def _check_ctx(self, other: "Ciphertext") -> None:
        if self.ctx != other.ctx:
            raise ValueError(f"context mismatch: {self.ctx} vs {other.ctx}")

    def __add__(self, other: "Ciphertext") -> "Ciphertext":
        if not isinstance(other, Ciphertext):
            return NotImplemented
        self._check_ctx(other)
        t1, t2 = self.chunks, other.chunks
        with op_metrics().record(
            "ct.add", chunks_in=t1 + t2, chunks_out=t1 + t2,
            bytes_moved=self.ctx.chunk_count_bytes(2 * (t1 + t2)),
        ):
            return Ciphertext(core.add_chunks(self.wt, other.wt), self.ctx)

    def __mul__(self, other: "Ciphertext") -> "Ciphertext":
        if not isinstance(other, Ciphertext):
            return NotImplemented
        self._check_ctx(other)
        t1, t2 = self.chunks, other.chunks
        with op_metrics().record(
            "ct.mul", chunks_in=t1 + t2, chunks_out=t1 * t2,
            bytes_moved=self.ctx.chunk_count_bytes(t1 + t2 + t1 * t2),
        ):
            return Ciphertext(dispatch.mul_chunks(self.wt, other.wt), self.ctx)

    def canonical(self) -> "Ciphertext":
        """Reference chunk order — what every ciphertext of the port has."""
        return self

    # -- interop ------------------------------------------------------------

    def chunk_major(self) -> np.ndarray:
        """Host-side chunk-major view in reference order: uint32[chunks, W]."""
        return layout.words_to_numpy(self.wt).T

    def to_u64(self) -> np.ndarray:
        """Reference-layout uint64 words, flat ``[chunks * words64]`` (host)."""
        return layout.u32_to_u64(self.chunk_major()).reshape(-1)

    @classmethod
    def from_u64(cls, words64: np.ndarray, ctx: Context, device="cpu") -> "Ciphertext":
        """Build from reference-layout uint64 words (flat or [chunks, words64])."""
        w64 = np.asarray(words64, dtype=np.uint64).reshape(-1, ctx.words64)
        return cls.from_chunk_major(layout.u64_to_u32(w64), ctx, device)

    @classmethod
    def from_chunk_major(cls, words: np.ndarray, ctx: Context, device="cpu") -> "Ciphertext":
        """Build from a chunk-major uint32[chunks, W] array."""
        return cls(layout.words_from_numpy(np.asarray(words, dtype=np.uint32).T, device), ctx)

    def bit_string(self) -> str:
        """The reference's `operator<<` rendering (src/Ciphertext.cpp:192-199)."""
        return layout.format_bits(self.chunk_major(), self.ctx.n)

    def __repr__(self) -> str:
        return (
            f"Ciphertext(chunks={self.chunks}, W={self.wt.shape[-2]}, "
            f"device={self.device}, ctx={self.ctx})"
        )
