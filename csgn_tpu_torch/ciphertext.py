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
  * **Lazy chunk order** — decryption is a parity over the multiset of
    chunks (src/SecretKey.cpp:126-140), so only the reference's byte layout
    pins a product's ``i*t2+j`` order (src/Ciphertext.cpp:159).  A product
    in another physical order (the JAX package's j-major and padded TPU
    routes, or `ops.dispatch.mul_chunks_jmajor` on request) carries a
    ``logical`` index tag (`ops.order`), resolved by one gather at the
    interop boundaries (`canonical`, `to_u64`); pad chunks (``pad``,
    all-zero chunks marked PAD in the tag) are decrypt-neutral.  A JAX
    ciphertext's tag and pads cross with it (`convert`), and a tagged
    operand's tag carries through ``*``, ``+`` and `apply_permutation`.
    The port's own ``*`` (`ops.dispatch.mul_chunks_auto`) writes the
    canonical order on the card and on the CPU, so canonical operands give
    canonical products; `set_eager_order(True)` makes every product
    canonical.  ``chunks`` is
    always the reference-visible (logical) count.
  * **No materialized bitlen** — derived from the context when needed.
  * **Contiguous words** — a view (``c.wt[:, :2]``) is copied on
    construction, since the kernels read dense rows.

Operators: ``+`` concatenates chunks, ``*`` is the chunk cross-product AND —
semantics parity with reference src/Ciphertext.cpp:107-179 — and
`apply_permutation` permutes the bits of every chunk.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from csgn_tpu_torch import layout
from csgn_tpu_torch.context import Context
from csgn_tpu_torch.ops import core, dispatch, order
from csgn_tpu_torch.permutation import Permutation
from csgn_tpu_torch.utils.metrics import op_metrics

__all__ = ["Ciphertext", "set_eager_order"]

# When True, every operator writes the canonical chunk order (strict per-op
# layout parity with the reference), as in the JAX package.
_EAGER_ORDER = False


def set_eager_order(eager: bool) -> bool:
    """Toggle physically-canonical chunk order for all new results.

    Returns the previous setting.  Lazy order (the default) is bit-exact at
    every interop boundary; eager mode also makes the raw payload `wt` match
    the reference order after every single op.
    """
    global _EAGER_ORDER
    prev = _EAGER_ORDER
    _EAGER_ORDER = bool(eager)
    return prev


def check_tag(wt: torch.Tensor, logical, pad: int, what: str) -> None:
    """The JAX package's tag checks (a pad needs a tag; the tag is one int32
    entry per physical chunk), plus the tag's device: the payload's."""
    if pad and logical is None:
        raise ValueError(f"padded {what} requires an order tag")
    if pad < 0 or pad > wt.shape[-1]:
        raise ValueError(f"{what} pad {pad} outside [0, {wt.shape[-1]}]")
    if logical is None:
        return
    if not isinstance(logical, torch.Tensor) or logical.dtype != torch.int32:
        raise TypeError("order tag must be an int32 torch.Tensor")
    if tuple(logical.shape) != (wt.shape[-1],):
        raise ValueError(
            f"order tag shape {tuple(logical.shape)} != physical chunks {wt.shape[-1]}"
        )
    if logical.device != wt.device:
        raise ValueError(f"order tag on {logical.device}, payload on {wt.device}")


@dataclasses.dataclass(frozen=True, eq=False)
class Ciphertext:
    """Packed ciphertext words ``int32[W, chunks]`` plus its context.

    ``logical`` (optional int32[physical chunks], on the payload's device)
    maps physical column p to its reference-order index; None means physical
    == canonical order.  ``pad`` counts the all-zero pad chunks (PAD in the
    tag).  ``eq=False``: tensor fields have no boolean ``==``; compare
    ``to_u64()`` or the canonical ``wt`` explicitly."""

    wt: torch.Tensor
    ctx: Context
    logical: torch.Tensor | None = None
    pad: int = 0

    def __post_init__(self):
        w = self.wt
        if not isinstance(w, torch.Tensor) or w.dtype != torch.int32:
            raise TypeError("ciphertext words must be an int32 torch.Tensor")
        if w.dim() != 2 or w.shape[0] != self.ctx.words32:
            raise ValueError(
                f"ciphertext words must be [W={self.ctx.words32}, chunks], got shape "
                f"{tuple(w.shape)}"
            )
        check_tag(w, self.logical, self.pad, "ciphertext")
        object.__setattr__(self, "wt", w.contiguous())  # frozen: set once, here

    # -- properties ---------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.wt.device

    @property
    def chunks(self) -> int:
        """Logical chunk count — what the reference layout has (pads excluded)."""
        return int(self.wt.shape[-1]) - self.pad

    @property
    def physical_chunks(self) -> int:
        """Device-resident chunk count, pad chunks included."""
        return int(self.wt.shape[-1])

    @property
    def is_canonical(self) -> bool:
        """True if the physical payload is already in reference chunk order."""
        return self.logical is None

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
            tag = order.concat_logical(self.logical, other.logical, t1, t2, device=self.device)
            return Ciphertext(
                core.add_chunks(self.wt, other.wt), self.ctx, tag, self.pad + other.pad
            )

    def __mul__(self, other: "Ciphertext") -> "Ciphertext":
        if not isinstance(other, Ciphertext):
            return NotImplemented
        self._check_ctx(other)
        t1, t2 = self.chunks, other.chunks
        with op_metrics().record(
            "ct.mul", chunks_in=t1 + t2, chunks_out=t1 * t2,
            bytes_moved=self.ctx.chunk_count_bytes(t1 + t2 + t1 * t2),
        ):
            if _EAGER_ORDER:
                a, b = self.canonical(), other.canonical()
                return Ciphertext(dispatch.mul_chunks(a.wt, b.wt), self.ctx)
            out, jmajor, zp_a, zp_b = dispatch.mul_chunks_auto(self.wt, other.wt)
            return Ciphertext(out, self.ctx, *product_tag(self, other, out, jmajor, zp_a, zp_b))

    def apply_permutation(self, p: Permutation) -> "Ciphertext":
        """Apply π per chunk (out bit i = in bit π[i]) via the Beneš
        delta-swap plan — packed-domain, no bit unpacking (bit-exact to the
        `ops.core.permute_chunks` gather oracle; see ops/permute_benes.py).
        Chunk positions are untouched (a pad chunk stays zero), so the order
        tag carries over."""
        if p.n != self.ctx.n:
            raise ValueError(f"permutation length {p.n} != context n {self.ctx.n}")
        with op_metrics().record(
            "ct.permute", chunks_in=self.chunks, chunks_out=self.chunks,
            bytes_moved=self.ctx.chunk_count_bytes(2 * self.physical_chunks),
        ):
            return Ciphertext(dispatch.permute(self.wt, p.benes_plan()), self.ctx,
                              self.logical, self.pad)

    # -- chunk order ---------------------------------------------------------

    def canonical(self) -> "Ciphertext":
        """Reference chunk order, pad chunks dropped (one gather on the
        payload's device; ``self`` if already canonical)."""
        if self.logical is None:
            return self
        return Ciphertext(order.canonicalize(self.wt, self.logical, self.chunks), self.ctx)

    # -- interop ------------------------------------------------------------

    def chunk_major(self) -> np.ndarray:
        """Host-side chunk-major view in reference order: uint32[chunks, W]."""
        return layout.words_to_numpy(self.canonical().wt).T

    def to_u64(self) -> np.ndarray:
        """Reference-layout uint64 words, flat ``[chunks * words64]`` (host)."""
        return layout.u32_to_u64(self.chunk_major()).reshape(-1)

    @classmethod
    def from_u64(cls, words64: np.ndarray, ctx: Context, device=None) -> "Ciphertext":
        """Build from reference-layout uint64 words (flat or [chunks, words64])
        on `device` (None = the current CUDA device, ``"cpu"`` for the CPU)."""
        w64 = np.asarray(words64, dtype=np.uint64).reshape(-1, ctx.words64)
        return cls.from_chunk_major(layout.u64_to_u32(w64), ctx, device)

    @classmethod
    def from_chunk_major(cls, words: np.ndarray, ctx: Context, device=None) -> "Ciphertext":
        """Build from a chunk-major uint32[chunks, W] array on `device`
        (None = the current CUDA device)."""
        return cls(layout.words_from_numpy(np.asarray(words, dtype=np.uint32).T, device), ctx)

    def bit_string(self) -> str:
        """The reference's `operator<<` rendering (src/Ciphertext.cpp:192-199)."""
        return layout.format_bits(self.chunk_major(), self.ctx.n)

    def __repr__(self) -> str:
        ordr = "canonical" if self.logical is None else "lazy"
        padinfo = f"+{self.pad}pad" if self.pad else ""
        return (
            f"Ciphertext(chunks={self.chunks}{padinfo}, W={self.wt.shape[-2]}, "
            f"order={ordr}, device={self.device}, ctx={self.ctx})"
        )


def product_tag(x, y, out: torch.Tensor, jmajor: bool, zp_a: int, zp_b: int) -> tuple:
    """``(logical, pad)`` of the product `out` of x and y (ciphertexts or
    batches) on a route that reported ``(jmajor, zp_a, zp_b)``: the
    operands' tags extended with the route's pads, crossed (JAX
    csgn_tpu/ciphertext.py:180-185)."""
    dev = out.device
    la = order.extend_with_pads(x.logical, x.chunks, zp_a, device=dev)
    lb = order.extend_with_pads(y.logical, y.chunks, zp_b, device=dev)
    tag = order.cross_logical(la, lb, x.chunks, y.chunks, jmajor=jmajor, device=dev)
    return tag, int(out.shape[-1]) - x.chunks * y.chunks
