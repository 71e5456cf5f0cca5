"""Batched ciphertexts: B independent ciphertexts as one ``int32[B, W, C]``.

Counterpart of `csgn_tpu.batch.CiphertextBatch`.  A batch of B same-shape
ciphertexts is one tensor with a leading batch axis, and every operator runs
once for the whole fleet:

  * add    — chunk concat per element              [B,W,Ca]+[B,W,Cb] -> [B,W,Ca+Cb]
  * mul    — chunk cross-product AND per element   [B,W,t1]*[B,W,t2] -> [B,W,t1*t2]
  * decrypt — per-element parity                   [B,W,C] -> bits[B]
    (`SecretKey.decrypt_batch`)
  * permute — one Beneš plan for every element (`apply_permutation`), or plan
    i on element i (`apply_permutations`, the key-rotation fleet; and
    `permute_each`, the same on separate ciphertexts read where they are
    stored, with no stack).

Kernel strategy: the CUDA kernels take the batch dimension natively (the
element comes from the grid), where the JAX package vmaps its Pallas
kernels.  Both operands of `*` must share B.

Fast paths:
  * fresh x fresh multiply (C == 1 both) is ONE elementwise AND — the batched
    analogue of the reference's defaultN_multiply (src/Ciphertext.cpp:124-131).
  * fresh-batch interop: `SecretKey.encrypt_batch` emits ``[W, B]`` (batch on
    the chunk axis); `from_fresh`/`to_fresh` are a transpose away.

Chunk order: batched `*` writes the same physical order for every element,
so ONE shared ``logical`` tag (`ops.order`) with its ``pad`` covers the
whole batch, as in the JAX package.  Unlike the JAX package, an
operator with a non-batch operand returns ``NotImplemented`` (so Python
raises TypeError or tries the other operand's method), and a batch of
B = 0 is rejected.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from csgn_tpu_torch import layout
from csgn_tpu_torch.ciphertext import Ciphertext, check_tag, product_tag
from csgn_tpu_torch.context import Context
from csgn_tpu_torch.ops import core, dispatch, order
from csgn_tpu_torch.ops import permute_benes as pb
from csgn_tpu_torch.permutation import Permutation
from csgn_tpu_torch.utils.metrics import op_metrics

__all__ = ["CiphertextBatch"]


@dataclasses.dataclass(frozen=True, eq=False)
class CiphertextBatch:
    """B same-shape ciphertexts: ``wt int32[B, W, chunks]`` + their context.

    ``logical``/``pad`` are the shared lazy-order tag (see `Ciphertext`):
    identical op sequences give identical physical orders, so one tag serves
    all B elements.  ``eq=False``: compare ``to_u64()`` explicitly."""

    wt: torch.Tensor
    ctx: Context
    logical: torch.Tensor | None = None
    pad: int = 0

    def __post_init__(self):
        w = self.wt
        if not isinstance(w, torch.Tensor) or w.dtype != torch.int32:
            raise TypeError("batched ciphertext words must be an int32 torch.Tensor")
        if w.dim() != 3 or w.shape[1] != self.ctx.words32:
            raise ValueError(
                f"batched ciphertext words must be [B, W={self.ctx.words32}, chunks], "
                f"got shape {tuple(w.shape)}"
            )
        if w.shape[0] == 0:
            raise ValueError("empty batch: a CiphertextBatch needs B >= 1")
        check_tag(w, self.logical, self.pad, "batch")
        object.__setattr__(self, "wt", w.contiguous())  # frozen: set once, here

    # -- properties -----------------------------------------------------------

    @property
    def batch(self) -> int:
        return int(self.wt.shape[0])

    @property
    def chunks(self) -> int:
        """Logical chunk count per element (pads excluded)."""
        return int(self.wt.shape[-1]) - self.pad

    @property
    def physical_chunks(self) -> int:
        """Device-resident chunks per element, pad chunks included."""
        return int(self.wt.shape[-1])

    @property
    def is_canonical(self) -> bool:
        return self.logical is None

    @property
    def device(self) -> torch.device:
        return self.wt.device

    @property
    def nbytes(self) -> int:
        return self.batch * self.ctx.chunk_count_bytes(self.chunks)

    # -- constructors ---------------------------------------------------------

    @classmethod
    def from_fresh(cls, words: torch.Tensor, ctx: Context) -> "CiphertextBatch":
        """From a fresh encrypt batch ``int32[W, B]`` (SecretKey.encrypt_batch)."""
        w, b = words.shape
        return cls(words.t().reshape(b, w, 1), ctx)

    @classmethod
    def stack(cls, cts: list[Ciphertext]) -> "CiphertextBatch":
        """Stack same-shape ciphertexts (canonicalized) into a batch."""
        if not cts:
            raise ValueError("empty batch")
        ctx = cts[0].ctx
        cs = [ct.canonical() for ct in cts]
        if any(c.ctx != ctx or c.chunks != cs[0].chunks for c in cs):
            raise ValueError("stack requires equal contexts and chunk counts")
        return cls(torch.stack([c.wt for c in cs]), ctx)

    def __getitem__(self, i: int) -> Ciphertext:
        """Element i as a single Ciphertext (shares the tag)."""
        return Ciphertext(self.wt[i], self.ctx, self.logical, self.pad)

    def to_fresh(self) -> torch.Tensor:
        """Back to the ``[W, B]`` fresh layout (requires chunks == 1)."""
        if self.chunks != 1:
            raise ValueError(f"not a fresh batch: {self.chunks} chunks")
        return self.canonical().wt.reshape(self.batch, -1).t().contiguous()

    # -- homomorphic operators -------------------------------------------------

    def _check(self, other: "CiphertextBatch") -> None:
        if self.ctx != other.ctx:
            raise ValueError("context mismatch")
        if self.batch != other.batch:
            raise ValueError(f"batch mismatch: {self.batch} vs {other.batch}")

    def __add__(self, other: "CiphertextBatch") -> "CiphertextBatch":
        if not isinstance(other, CiphertextBatch):
            return NotImplemented
        self._check(other)
        t1, t2 = self.chunks, other.chunks
        with op_metrics().record(
            "batch.add", chunks_in=self.batch * (t1 + t2), chunks_out=self.batch * (t1 + t2),
            bytes_moved=2 * self.batch * self.ctx.chunk_count_bytes(t1 + t2),
        ):
            tag = order.concat_logical(self.logical, other.logical, t1, t2, device=self.device)
            return CiphertextBatch(
                core.add_chunks(self.wt, other.wt), self.ctx, tag, self.pad + other.pad
            )

    def __mul__(self, other: "CiphertextBatch") -> "CiphertextBatch":
        if not isinstance(other, CiphertextBatch):
            return NotImplemented
        self._check(other)
        t1, t2 = self.chunks, other.chunks
        with op_metrics().record(
            "batch.mul", chunks_in=self.batch * (t1 + t2), chunks_out=self.batch * t1 * t2,
            bytes_moved=self.batch * self.ctx.chunk_count_bytes(t1 + t2 + t1 * t2),
        ):
            if t1 == 1 and t2 == 1 and self.pad == 0 and other.pad == 0:
                # Batched defaultN fast path: one elementwise AND.
                return CiphertextBatch(self.wt & other.wt, self.ctx)
            out, jmajor, zp_a, zp_b = dispatch.mul_chunks_batched(self.wt, other.wt)
            return CiphertextBatch(out, self.ctx,
                                   *product_tag(self, other, out, jmajor, zp_a, zp_b))

    def apply_permutation(self, p: Permutation) -> "CiphertextBatch":
        """Apply the same π to every element (per-chunk bit permutation)."""
        if p.n != self.ctx.n:
            raise ValueError(f"permutation length {p.n} != context n {self.ctx.n}")
        with op_metrics().record(
            "batch.permute", chunks_in=self.batch * self.chunks,
            chunks_out=self.batch * self.chunks,
            bytes_moved=2 * self.batch * self.ctx.chunk_count_bytes(self.physical_chunks),
        ):
            return CiphertextBatch(dispatch.permute_batched(self.wt, p.benes_plan()), self.ctx,
                                   self.logical, self.pad)

    def apply_permutations(self, perms: list[Permutation]) -> "CiphertextBatch":
        """Apply permutation i to batch element i (one per element).

        The key-rotation-fleet pattern: B ciphertexts re-keyed under B
        distinct transforms in one kernel launch.  All plans share the delta
        schedule (same n), so they stack into one mask tensor
        (`ops.permute_benes.stack_plans`) and the kernel picks element i's
        masks by its batch index; chunk positions are untouched, so the
        shared order tag carries over.  The stack and its masks' copy to
        the device are the span ``perm.stack_plans`` (`utils.metrics`).
        """
        if len(perms) != self.batch:
            raise ValueError(f"need {self.batch} permutations, got {len(perms)}")
        if any(p.n != self.ctx.n for p in perms):
            raise ValueError(f"permutation length mismatch vs context n {self.ctx.n}")
        with op_metrics().span("perm.stack_plans"):
            stacked = pb.stack_plans([p.benes_plan() for p in perms])
            pb.device_operands(stacked, self.device)
        with op_metrics().record(
            "batch.permute_multi", chunks_in=self.batch * self.chunks,
            chunks_out=self.batch * self.chunks,
            bytes_moved=2 * self.batch * self.ctx.chunk_count_bytes(self.physical_chunks),
        ):
            return CiphertextBatch(dispatch.permute_batched_multi(self.wt, stacked), self.ctx,
                                   self.logical, self.pad)

    @classmethod
    def permute_each(cls, cts: list[Ciphertext], perms: list[Permutation]) -> "CiphertextBatch":
        """``CiphertextBatch(stack of cts).apply_permutations(perms)`` with no
        stack: ciphertext i and the Beneš plan of ``perms[i]`` are read where
        they are stored, ciphertext i permuted into element i of the result
        (K9's table form, `dispatch.permute_requests`; on the register path
        only, n <= 2048).  The ciphertexts share one context and physical
        shape and one order tag: all canonical, or one tag object and pad,
        which the result keeps.  Each plan's masks go to the device once and
        stay (`permute_benes.table_operands`), under the span
        ``perm.stack_plans``; counted as `apply_permutations`."""
        if not cts or len(perms) != len(cts):
            raise ValueError(f"need one permutation a ciphertext, got {len(perms)} for "
                             f"{len(cts)}")
        first = cts[0]
        if any(c.ctx != first.ctx for c in cts):
            raise ValueError("permute_each: ciphertext contexts differ")
        if any(c.logical is not first.logical or c.pad != first.pad for c in cts):
            raise ValueError("permute_each: ciphertexts must share one order tag")
        if any(p.n != first.ctx.n for p in perms):
            raise ValueError(f"permutation length mismatch vs context n {first.ctx.n}")
        with op_metrics().span("perm.stack_plans"):
            plans = [p.benes_plan() for p in perms]
            pb.table_operands(plans, first.device)
        b = len(cts)
        with op_metrics().record(
            "batch.permute_multi", chunks_in=b * first.chunks, chunks_out=b * first.chunks,
            bytes_moved=2 * b * first.ctx.chunk_count_bytes(first.physical_chunks),
        ):
            return cls(dispatch.permute_requests([c.wt for c in cts], plans), first.ctx,
                       first.logical, first.pad)

    # -- chunk order ------------------------------------------------------------

    def canonical(self) -> "CiphertextBatch":
        """Reference chunk order for every element, pad chunks dropped (one
        gather on the payload's device; ``self`` if already canonical)."""
        if self.logical is None:
            return self
        return CiphertextBatch(order.canonicalize(self.wt, self.logical, self.chunks), self.ctx)

    # -- interop ---------------------------------------------------------------

    def to_u64(self) -> np.ndarray:
        """Reference-layout uint64 words per element: ``[B, chunks*words64]``."""
        cm = layout.words_to_numpy(self.canonical().wt).transpose(0, 2, 1)
        return layout.u32_to_u64(cm.reshape(-1, cm.shape[-1])).reshape(self.batch, -1)

    def __repr__(self) -> str:
        ordr = "canonical" if self.logical is None else "lazy"
        padinfo = f"+{self.pad}pad" if self.pad else ""
        return (
            f"CiphertextBatch(B={self.batch}, chunks={self.chunks}{padinfo}, "
            f"W={self.wt.shape[-2]}, order={ordr}, device={self.device}, ctx={self.ctx})"
        )
