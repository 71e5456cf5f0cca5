"""Host randomness of the port: `jax.random`'s threefry keys and samplers, and
glibc `rand()` for the reference-compatible goldens.

Counterpart of the `jax.random` calls the JAX package makes (this package
imports nothing of JAX): `key`, `split`, `fold_in`, `bits`, `randint`,
`uniform`, `bernoulli`, `permutation`, `key_data` and `wrap_key_data` return
bit for bit what `jax.random` returns for the same key, so a key, a
permutation or a ciphertext that the JAX package draws from
``jax.random.key(s)`` is drawn here from ``rng.key(s)``.  They follow the
definitions of ``jax/_src/prng.py`` (`threefry_seed`,
`_threefry_split_foldlike`, `_threefry_fold_in`,
`_threefry_random_bits_partitionable`) and ``jax/_src/random.py``
(`_randint`, `_uniform`, `_bernoulli`, `_shuffle`):

  * a key is two uint32 words (k0, k1), the threefry2x32-20 key;
    ``key(seed)`` is ``(0, seed mod 2^32)``, as `jax.random.key` gives on
    its default 32-bit setting (no ``jax_enable_x64``) for any seed in
    [-2^63, 2^63);
  * ``split(k, n)[i]`` and ``fold_in(k, i)`` are both ``threefry(k, (0, i))``;
  * ``bits(k, shape)`` at flat index x is ``y0 ^ y1`` of
    ``threefry(k, (x >> 32, x mod 2^32))``.

This is the **partitionable** layout (``jax_threefry_partitionable``), the
default since JAX 0.5, which the JAX package relies on (its conftest pins
it, and `csgn_tpu.parallel.sharded_encrypt_bits_invariant` needs it).  Under
the legacy layout `split` and `bits` draw other streams.

The samplers run on the host (torch int64 masked to 32 bits, numpy for the
results); ``threefry2x32`` also takes Python ints and then returns ints.

`GlibcRand` is a bit-exact emulation of glibc's `rand()`, the generator of
every random bit of the reference library (reference
src/SecretKey.cpp:47,51,76 and src/Permutation.cpp:150-153):
`csgn_tpu_torch.refcompat` replays the reference's ciphertexts and
permutations for a pinned `srand` seed with it
(tests/golden/golden_vectors.json; tests/test_torch_golden_native.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "Key", "key", "key_data", "wrap_key_data", "split", "fold_in", "bits", "randint",
    "uniform", "bernoulli", "permutation", "threefry2x32", "GlibcRand",
]

_M32 = 0xFFFFFFFF
_TF_ROT = (13, 15, 26, 6, 17, 29, 16, 24)


def threefry2x32(k0: int, k1: int, c0, c1):
    """Threefry-2x32-20 (Random123) keyed by uint32 words (k0, k1), on
    counters (c0, c1): int64 tensors of uint32 values, or Python ints.
    Returns (y0, y1) in [0, 2^32), of the counters' type."""
    ks = (k0 & _M32, k1 & _M32, (0x1BD11BDA ^ k0 ^ k1) & _M32)
    x0 = (c0 + ks[0]) & _M32
    x1 = (c1 + ks[1]) & _M32
    for i in range(20):
        r = _TF_ROT[i % 8]
        x0 = (x0 + x1) & _M32
        x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
        x1 = x1 ^ x0
        if i % 4 == 3:
            inj = i // 4 + 1
            x0 = (x0 + ks[inj % 3]) & _M32
            x1 = (x1 + ks[(inj + 1) % 3] + inj) & _M32
    return x0, x1


@dataclass(frozen=True)
class Key:
    """A `jax.random` threefry key: its two uint32 words, ``key_data``'s
    order.  A value of its own, never an int, so an API can tell a key from
    an integer seed."""

    k0: int
    k1: int

    def __post_init__(self):
        for w in (self.k0, self.k1):
            if not isinstance(w, int) or not 0 <= w <= _M32:
                raise ValueError(f"Key words must be ints in [0, 2^32), got {self.k0!r}, "
                                 f"{self.k1!r}")


def key(seed: int) -> Key:
    """``jax.random.key(seed)``: the words ``(0, seed mod 2^32)`` for a seed in
    [-2^63, 2^63) (OverflowError outside, as JAX raises)."""
    if isinstance(seed, (bool, np.bool_)) or not isinstance(seed, (int, np.integer)):
        raise TypeError(f"key: seed must be an integer, got {type(seed).__name__}")
    if isinstance(seed, int) and not -(1 << 63) <= seed < 1 << 63:
        raise OverflowError(f"key: seed {seed} does not fit in int64")
    return Key(0, int(seed) & _M32)


def key_data(k: Key) -> np.ndarray:
    """``jax.random.key_data(k)``: uint32[2]."""
    return np.array([k.k0, k.k1], dtype=np.uint32)


def wrap_key_data(data) -> Key:
    """``jax.random.wrap_key_data(data)``: the key of two uint32 words."""
    a, b = np.asarray(data, dtype=np.uint32).reshape(2)
    return Key(int(a), int(b))


def _check_key(name: str, k) -> Key:
    if not isinstance(k, Key):
        raise TypeError(f"{name}: expected an rng.Key, got {type(k).__name__}")
    return k


def _fold(k: Key, i: int) -> Key:
    return Key(*threefry2x32(k.k0, k.k1, 0, i))


def split(k: Key, num: int = 2) -> tuple[Key, ...]:
    """``jax.random.split(k, num)``: key i is ``threefry(k, (0, i))``."""
    _check_key("split", k)
    if num < 0:
        raise ValueError(f"split: num must be >= 0, got {num}")
    if num <= 32:  # Python ints: ~15 us a key, against ~0.8 ms for torch's ops
        return tuple(_fold(k, i) for i in range(num))
    y0, y1 = threefry2x32(k.k0, k.k1, torch.zeros(num, dtype=torch.int64),
                          torch.arange(num, dtype=torch.int64))
    return tuple(Key(a, b) for a, b in zip(y0.tolist(), y1.tolist()))


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)`` for data in [0, 2^32):
    ``threefry(k, (0, data))``."""
    _check_key("fold_in", k)
    data = int(data)
    if not 0 <= data <= _M32:
        raise OverflowError(f"fold_in: data {data} out of bounds for uint32")
    return _fold(k, data)


def _shape(shape) -> tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(int(s) for s in shape)


def bits_flat(k: Key, index: torch.Tensor) -> torch.Tensor:
    """The partitionable bits stream of `k` at flat indices `index` (int64,
    any device): ``y0 ^ y1`` of ``threefry(k, (x >> 32, x mod 2^32))``, int64
    in [0, 2^32)."""
    y0, y1 = threefry2x32(k.k0, k.k1, index >> 32, index & _M32)
    return y0 ^ y1


def bits(k: Key, shape=()) -> np.ndarray:
    """``jax.random.bits(k, shape)`` (uint32)."""
    _check_key("bits", k)
    shape = _shape(shape)
    out = bits_flat(k, torch.arange(math.prod(shape), dtype=torch.int64))
    return out.numpy().astype(np.uint32).reshape(shape)


def randint_mod(span: int, hb, lb):
    """`jax.random.randint`'s offset in [0, span) from its two uint32 draws
    (`_randint`, with uint32 wraparound): ``((hb % span) * mult + lb % span)
    % span``, ``mult = (2^16 % span)^2 % span``.  `hb` and `lb` are int64
    tensors or ints of uint32 values; ``span`` in [1, 2^32)."""
    mult = (((1 << 16) % span) ** 2 & _M32) % span
    return ((((hb % span) * mult) & _M32) + lb % span & _M32) % span


def randint(k: Key, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(k, shape, minval, maxval)`` (int32) for int32
    bounds (OverflowError outside, as JAX raises on its default 32-bit
    setting); span 1 where ``maxval <= minval``."""
    _check_key("randint", k)
    shape = _shape(shape)
    i32 = np.iinfo(np.int32)
    lo, hi = int(minval), int(maxval)
    if not (i32.min <= lo <= i32.max and i32.min <= hi <= i32.max):
        raise OverflowError(f"randint: bounds {lo}, {hi} do not fit in int32")
    k1, k2 = split(k)
    idx = torch.arange(math.prod(shape), dtype=torch.int64)
    off = randint_mod(hi - lo if hi > lo else 1, bits_flat(k1, idx), bits_flat(k2, idx))
    out = ((off + lo) & _M32).numpy().astype(np.uint32).view(np.int32)
    return out.reshape(shape)


def uniform(k: Key, shape=()) -> np.ndarray:
    """``jax.random.uniform(k, shape)`` (float32 in [0, 1)): the top 23 bits
    as the mantissa of a float in [1, 2), minus 1."""
    _check_key("uniform", k)
    u = ((bits(k, shape) >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return np.maximum(np.float32(0), u - np.float32(1))


def bernoulli(k: Key, p: float = 0.5, shape=None) -> np.ndarray:
    """``jax.random.bernoulli(k, p, shape)`` for a float `p` (float32, the
    default ``mode="low"``): ``uniform(k, shape) < p``."""
    _check_key("bernoulli", k)
    p = np.asarray(p, dtype=np.float32)
    return uniform(k, p.shape if shape is None else shape) < p


def permutation(k: Key, n: int) -> np.ndarray:
    """``jax.random.permutation(k, n)`` (int32[n]): ceil(3 ln n / ln(2^32 - 1))
    rounds, each ``k, sub = split(k)`` and a stable sort of the entries by
    ``bits(sub, (n,))``."""
    _check_key("permutation", k)
    n = int(n)
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    idx = torch.arange(n, dtype=torch.int64)
    for _ in range(rounds):
        k, sub = split(k)
        order = torch.sort(bits_flat(sub, idx), stable=True).indices.numpy()
        x = x[order]
    return x


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
