"""Bit-position permutations: generation, composition, inversion.

Counterpart of `csgn_tpu.permutation.Permutation` (reference
`certFHE::Permutation`, src/Permutation.{h,cpp}).  Semantics parity:

  * applying π to an object maps output bit i from input bit π[i]
    (reference src/Ciphertext.cpp:33-34, src/SecretKey.cpp:241-242);
  * composition ``p + q`` is ``(p+q)[i] = p[q[i]]``
    (reference src/Permutation.cpp:63-78);
  * ``p + p.inverse()`` is the identity (reference tests/permutations.cpp:49-53).

The permutation itself is host-side numpy, as in the JAX package.  `random`
draws from an `rng.Key` what `jax.random.permutation` draws from the same
key, so both packages give the same permutation.
"""

from __future__ import annotations

import numpy as np

from csgn_tpu_torch import rng
from csgn_tpu_torch.utils.metrics import op_metrics

__all__ = ["Permutation"]


class Permutation:
    """A permutation of bit positions [0, n)."""

    __slots__ = ("perm", "_plan")

    def __init__(self, perm: np.ndarray):
        perm = np.asarray(perm, dtype=np.int32)
        if perm.ndim != 1:
            raise ValueError("permutation must be 1-D")
        self.perm = perm
        self.perm.setflags(write=False)
        self._plan = None

    def benes_plan(self):
        """Cached Beneš delta-swap routing (see ops.permute_benes); the plan
        also caches its device copies, so repeated rotations upload nothing.
        A build (a cache miss) counts under ``perm.plan_builds`` and is the
        span ``perm.plan`` while spans are recorded (`utils.metrics`)."""
        if self._plan is None:
            from csgn_tpu_torch.ops.permute_benes import build_plan

            metrics = op_metrics()
            metrics.count("perm.plan_builds")
            with metrics.span("perm.plan"):
                self._plan = build_plan(self.perm, self.n)
        return self._plan

    # -- constructors -------------------------------------------------------

    @classmethod
    def random(cls, n, key: rng.Key) -> "Permutation":
        """Uniform random permutation of [0, n) from an `rng.Key`:
        ``jax.random.permutation(key, n)``, the JAX package's
        `Permutation.random(n, key)` bit for bit."""
        n = getattr(n, "n", n)  # accept a Context or an int
        if not isinstance(key, rng.Key):
            raise TypeError(f"Permutation.random: expected an rng.Key, got {type(key).__name__}")
        return cls(rng.permutation(key, int(n)))

    @classmethod
    def identity(cls, n) -> "Permutation":
        n = getattr(n, "n", n)
        return cls(np.arange(int(n), dtype=np.int32))

    # -- algebra ------------------------------------------------------------

    @property
    def n(self) -> int:
        return int(self.perm.shape[0])

    def inverse(self) -> "Permutation":
        """π⁻¹ with π⁻¹[π[j]] = j (argsort; the reference searches in O(n²),
        src/Permutation.cpp:8-27)."""
        return Permutation(np.argsort(self.perm).astype(np.int32))

    def __add__(self, other: "Permutation") -> "Permutation":
        """Compose: (self + other)[i] = self[other[i]] (reference op+)."""
        if self.n != other.n:
            raise ValueError(f"length mismatch: {self.n} vs {other.n}")
        return Permutation(self.perm[other.perm])

    def is_identity(self) -> bool:
        return bool(np.array_equal(self.perm, np.arange(self.n)))

    def __eq__(self, other) -> bool:
        if not isinstance(other, Permutation):
            return NotImplemented
        return np.array_equal(self.perm, other.perm)

    def __hash__(self):
        return hash(("Permutation", self.perm.tobytes()))

    def __repr__(self) -> str:
        return f"Permutation(n={self.n})"

    def __str__(self) -> str:
        # Two-line cycle notation, as the reference prints it
        # (src/Permutation.cpp:33-46).
        top = " ".join(str(i) for i in range(self.n))
        bot = " ".join(str(int(x)) for x in self.perm)
        return f"({top} )\n({bot} )"
