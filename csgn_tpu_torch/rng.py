"""glibc `rand()` replay, for the reference-compatible goldens.

Counterpart of `csgn_tpu.rng` (a copy: this package imports nothing of the
JAX package).  The reference library draws every random bit from C `rand()`
(reference src/SecretKey.cpp:47,51,76 and src/Permutation.cpp:150-153).
`GlibcRand` is a bit-exact emulation of glibc's additive-feedback TYPE_3
generator, so `csgn_tpu_torch.refcompat` can replay the reference's
ciphertexts and permutations for a pinned `srand` seed without linking any C
code (tests/golden/golden_vectors.json; tests/test_torch_golden_native.py).

It is host-side pure Python / numpy, for goldens and reference-compatible
encoding only; the port's own encryption is the counter engine
(`ops.encrypt_kernels`).
"""

from __future__ import annotations

import numpy as np

__all__ = ["GlibcRand"]


class GlibcRand:
    """Bit-exact emulation of glibc `srand`/`rand` (TYPE_3, degree 31, sep 3).

    After seeding, state r[0..343] is built as:
      r[0] = seed (or 1 if seed == 0)
      r[i] = 16807 * r[i-1] mod 2^31-1        for i in [1, 31)
      r[i] = r[i-31]                           for i in [31, 34)
      r[i] = (r[i-31] + r[i-3]) mod 2^32       for i in [34, 344)
    and each `rand()` output is ((r[i-31] + r[i-3]) mod 2^32) >> 1.
    """

    def __init__(self, seed: int):
        r = [0] * 344
        r[0] = seed & 0xFFFFFFFF
        if r[0] == 0:
            r[0] = 1
        for i in range(1, 31):
            # Signed Schrage multiplication, as glibc does it.
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 31] + r[i - 3]) & 0xFFFFFFFF
        # Keep a rolling window of the last 31 values.
        self._state = r[313:344]

    def rand(self) -> int:
        """One `rand()` call: value in [0, 2^31)."""
        s = self._state
        v = (s[0] + s[28]) & 0xFFFFFFFF
        s.pop(0)
        s.append(v)
        return v >> 1

    def randmod(self, m: int) -> int:
        """`rand() % m` — the reference's only idiom (e.g. src/SecretKey.cpp:47)."""
        return self.rand() % m

    def rand_array(self, count: int) -> np.ndarray:
        """Vector of `count` successive rand() values (int64)."""
        return np.array([self.rand() for _ in range(count)], dtype=np.int64)
