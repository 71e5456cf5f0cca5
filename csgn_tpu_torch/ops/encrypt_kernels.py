"""Batched encrypt: the JAX package's default engine (K14), the counter
engine (K4) and the Philox engine (K7), the Philox stream dump (K13), each
with its plain torch version.

**The default engine** (K14), `encrypt_bits_threefry`, is the JAX
package's `csgn_tpu.ops.core.encrypt_bits` under a `jax.random` key
(`rng.Key`), bit for bit; its plain version is
`ops.core.encrypt_bits_threefry_plain`, which states the draws.  The kernel
takes the four keys the host splits (`threefry_engine_keys`): one threefry
call a word at the flat index ``r * total + j`` of the word array, randint's
two draws and the coin at index j, and K4's fix-up.  ``col0`` and ``total``
make the batch the columns ``[col0, col0 + batch)`` of an encrypt of
``total`` columns (a rank's slice of the mesh-invariant sharded encrypt).

K4 and K7 draw a stream of R = W + 2 uint32 rows per column j of the
batch and derive the ciphertext words from it with one fix-up,
`derive_words` (the JAX package's `_encrypt_derive`,
csgn_tpu/ops/encrypt_pallas.py:193-214): rows [0, W) are the chunk words
(& the valid mask), row W selects the broken secret index (``% d``,
unsigned), row W + 1 gives the bit-0 coin.  The CUDA kernels
(csrc/encrypt.cu) share the same fix-up as one device function, templated
on the generator.

**Counter engine** (K4), counterpart of
`csgn_tpu.ops.encrypt_pallas.encrypt_bits_counter`, bit-exactly.  Stream spec
(encrypt_pallas.py:152-157): R rounded up to even, R2 = R // 2; for pair k in
[0, R2) and column j, ``(y0, y1) = threefry2x32(key=(seed_lo, seed_hi),
ctr=(k, j))``; stream row k is y0 and row R2 + k is y1.

**Philox engine** (K7), counterpart of the JAX package's hardware-PRNG
engine `encrypt_bits_pallas` (``engine="pallas"``).  The TPU kernel draws
from the TPU's own generator, seeded per block, and is not reproducible by
design; this engine is a counter-based Philox whose bits are fixed.  Stream
spec (fixed; changing it is a format break): G = ceil(R / 4) groups per
column; for group g and global column j,
``(y0, y1, y2, y3) = philox4x32_10(ctr=(j, g, 0, 0), key=(seed_lo, seed_hi))``
and stream row 4g + l is y_l.  The output depends only on (key, seed, bit,
j), for any batch size and any block size of the kernel — unlike the TPU
kernel's, whose draws depend on its ``block_b``.  The two engines share the
invariants (canonical words, a bit-1 chunk matches the key, a bit-0 chunk
does not), not the bits.

K7 has two paths on the card, chosen by shape (`philox_path`), each
counted under its own ``LAUNCHES`` key as well as ``encrypt_bits_philox``:
the tile path for W <= `PHILOX_TILE_MAX_WORDS` (a block generates
`PHILOX_TILE_COLS` columns into a shared tile, patches the broken secret
bit there and writes each row contiguously: 16-byte stores when batch % 4
== 0, ``"philox_tile"``, else 4-byte ones, also ``"philox_tile_4byte"``),
and the column path above it (one thread a column storing straight to
global memory, ``"philox_column"``).  Both write the same words.

`philox_streams` (K13) is the Philox stream itself, every row and no fix-up:
the counterpart of the clone kernel of tools/enc_stats.py, which had to
imitate K7's draws by hand; here it is K7's kernel with every row stored.

The plain versions run the uint32 arithmetic in int64 masked to 32 bits
(torch has no uint32 add, multiply, shift or ``%``) and wrap the words to the
int32 view.  Philox's 32 x 32-bit products would overflow int64, so one
factor is split into 16-bit halves and every partial product stays below
2^48.

Both engines take a global column base ``col0``: the batch is the stream's
columns ``[col0, col0 + batch)``, so a rank that encrypts its block of a
batch-sharded encrypt gets exactly the one-device encrypt's columns of that
block (`parallel.sharded_encrypt_bits`).  The JAX counter stream takes the
same base (`_counter_stream(..., col0)`, csgn_tpu/ops/encrypt_pallas.py:278).
"""

from __future__ import annotations

import torch

from csgn_tpu_torch import rng
from csgn_tpu_torch._device import resolve_device
from csgn_tpu_torch.ops._build import LAUNCHES, check, lib, ptr, stream_of
from csgn_tpu_torch.ops.core import encrypt_bits_threefry_plain
from csgn_tpu_torch.rng import threefry2x32

__all__ = [
    "LAUNCHES",
    "threefry2x32",
    "philox4x32_10",
    "mulhilo32",
    "derive_words",
    "encrypt_bits_counter",
    "encrypt_bits_counter_plain",
    "encrypt_bits_philox",
    "encrypt_bits_philox_plain",
    "encrypt_bits_threefry",
    "encrypt_bits_threefry_plain",
    "threefry_engine_keys",
    "philox_path",
    "PHILOX_TILE_COLS",
    "PHILOX_TILE_MAX_WORDS",
    "philox_streams",
    "philox_streams_plain",
]

_M32 = 0xFFFFFFFF
# K7's tile: columns a block (kTileCols in csrc/encrypt.cu) and the widest W
# it takes (kTileMaxWords); the two must match the source.
PHILOX_TILE_COLS = 128
PHILOX_TILE_MAX_WORDS = 192
_PHILOX_PATHS = {"column": 0, "tile": 1, "tile_4byte": 2}
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def mulhilo32(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit halves of the 64-bit product m * x, for a uint32
    constant m and an int64 tensor x of uint32 values.  x is split into
    16-bit halves, so each partial product is below 2^48 and nothing relies
    on int64 wraparound."""
    a = m * (x >> 16)              # < 2^48
    b = m * (x & 0xFFFF)           # < 2^48
    hi = (a + (b >> 16)) >> 16
    lo = (((a & 0xFFFF) << 16) + b) & _M32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox-4x32-10 (Random123) on int64 tensors (or ints) holding uint32
    counters, with a uint32 key (k0, k1); returns (y0, y1, y2, y3) as int64
    in [0, 2^32).  The key schedule is host integers."""
    k0, k1 = k0 & _M32, k1 & _M32
    for i in range(10):
        if i:
            k0 = (k0 + _PHILOX_W[0]) & _M32
            k1 = (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = mulhilo32(_PHILOX_M[0], torch.as_tensor(c0, dtype=torch.int64))
        hi1, lo1 = mulhilo32(_PHILOX_M[1], torch.as_tensor(c2, dtype=torch.int64))
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _seed_halves(seed: int) -> tuple[int, int]:
    return int(seed) & _M32, (int(seed) >> 32) & _M32


def derive_words(stream: torch.Tensor, bits: torch.Tensor, key_idx: torch.Tensor,
                 mask: torch.Tensor, valid_mask: torch.Tensor) -> torch.Tensor:
    """The encrypt fix-up, shared by both engines: stream rows int64
    ``[>= W + 2, batch]`` (uint32 values) -> words int32 ``[W, batch]``.

    Mirrors `_encrypt_derive` (csgn_tpu/ops/encrypt_pallas.py:193-214): bit 1
    ORs in the mask; bit 0 breaks secret position key[r], r = row W % d,
    forcing it to 0 if the other secret bits are all 1 and to the coin
    (row W + 1 & 1) otherwise; bits at positions >= n are zero.
    """
    w, d = mask.shape[0], key_idx.shape[0]
    dev = stream.device
    # The int64 -> int32 casts wrap [0, 2^32) onto the int32 view.
    words = stream[:w].to(torch.int32) & valid_mask[:, None]
    pos = key_idx.to(torch.int64)[stream[w] % d]                  # [batch]
    r_bit = (torch.ones_like(pos) << (31 - pos % 32)).to(torch.int32)
    rows = torch.arange(w, dtype=torch.int64, device=dev)[:, None]
    onehot = torch.where(rows == (pos // 32)[None, :], r_bit[None, :], 0)
    mask_wo = mask[:, None] & ~onehot
    others_all_one = ((words & mask_wo) == mask_wo).all(dim=0)
    coin = (stream[w + 1] & 1) == 1
    forced = torch.where(coin & ~others_all_one, onehot, 0)
    zero_words = (words & ~onehot) | forced
    is_one = ((bits.to(torch.int64) & 1) == 1)[None, :]
    return torch.where(is_one, words | mask[:, None], zero_words)


# ---------------------------------------------------------------------------
# Plain streams and engines
# ---------------------------------------------------------------------------


def _counter_stream(seed: int, w: int, batch: int, device, col0: int = 0) -> torch.Tensor:
    r2 = (w + 3) // 2
    seed_lo, seed_hi = _seed_halves(seed)
    c0 = torch.arange(r2, dtype=torch.int64, device=device)[:, None].expand(r2, batch)
    c1 = torch.arange(col0, col0 + batch, dtype=torch.int64,
                      device=device)[None, :].expand(r2, batch)
    y0, y1 = threefry2x32(seed_lo, seed_hi, c0, c1)
    return torch.cat([y0, y1])                                    # [2 * r2, batch]


def philox_streams_plain(seed: int, batch: int, rows: int, device=None,
                         col0: int = 0) -> torch.Tensor:
    """The Philox engine's raw stream, rows int64 ``[rows, batch]`` of uint32
    values (see the module docstring) at columns ``[col0, col0 + batch)``,
    computed one group of four rows at a time."""
    device = resolve_device(device)
    seed_lo, seed_hi = _seed_halves(seed)
    j = torch.arange(col0, col0 + batch, dtype=torch.int64, device=device)
    out = []
    for g in range(-(-rows // 4)):
        out.extend(philox4x32_10(j, g, 0, 0, seed_lo, seed_hi))
    if not out:
        return torch.empty((0, batch), dtype=torch.int64, device=device)
    return torch.stack([torch.as_tensor(y, dtype=torch.int64, device=device)
                        .expand(batch) for y in out[:rows]])


def encrypt_bits_counter_plain(seed: int, bits: torch.Tensor, key_idx: torch.Tensor,
                               mask: torch.Tensor, valid_mask: torch.Tensor, *,
                               col0: int = 0) -> torch.Tensor:
    """Encrypt bits[batch] -> int32[W, batch] on the counter engine at
    columns ``[col0, col0 + batch)`` (plain torch, any device)."""
    stream = _counter_stream(seed, mask.shape[0], bits.shape[0], bits.device, col0)
    return derive_words(stream, bits, key_idx, mask, valid_mask)


def encrypt_bits_philox_plain(seed: int, bits: torch.Tensor, key_idx: torch.Tensor,
                              mask: torch.Tensor, valid_mask: torch.Tensor, *,
                              col0: int = 0) -> torch.Tensor:
    """Encrypt bits[batch] -> int32[W, batch] on the Philox engine at
    columns ``[col0, col0 + batch)`` (plain torch, any device)."""
    stream = philox_streams_plain(seed, bits.shape[0], mask.shape[0] + 2, bits.device, col0)
    return derive_words(stream, bits, key_idx, mask, valid_mask)


# ---------------------------------------------------------------------------
# Wrappers: CPU tensors take the plain version, CUDA tensors the kernel
# ---------------------------------------------------------------------------


def _check_encrypt_operands(name, bits, key_idx, mask, valid_mask, col0: int = 0) -> None:
    for arg, t in (("bits", bits), ("key_idx", key_idx), ("mask", mask),
                   ("valid_mask", valid_mask)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a torch.Tensor")
        if t.dim() != 1:
            raise ValueError(f"{name}: {arg} must be 1-D, got {tuple(t.shape)}")
        if t.device != bits.device or t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: operands must share one cpu or cuda device")
    for arg, t in (("key_idx", key_idx), ("mask", mask), ("valid_mask", valid_mask)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} must be int32, got {t.dtype}")
    if bits.dtype.is_floating_point or bits.dtype.is_complex:
        raise TypeError(f"{name}: bits must be integer or bool, got {bits.dtype}")
    if mask.shape != valid_mask.shape:
        raise ValueError(f"{name}: mask and valid_mask must both be [W]")
    if key_idx.shape[0] < 1:
        raise ValueError(f"{name}: need at least one key index")
    if bits.shape[0] >= 1 << 32:
        raise ValueError(f"{name}: batch must be < 2^32 (uint32 counters)")
    if col0 < 0 or col0 + bits.shape[0] > 1 << 32:
        raise ValueError(f"{name}: columns [col0, col0 + batch) must lie in [0, 2^32), "
                         f"got col0={col0}")


def philox_path(w: int, batch: int) -> str:
    """K7's path on the card for W = `w` and `batch` columns: "tile" (16-byte
    row stores), "tile_4byte" (4-byte row stores, batch % 4 != 0) or
    "column" (W > `PHILOX_TILE_MAX_WORDS`)."""
    if w > PHILOX_TILE_MAX_WORDS:
        return "column"
    return "tile" if batch % 4 == 0 else "tile_4byte"


def _encrypt_cuda(name: str, entry: str, bits, key_idx, mask, valid_mask, col0: int,
                  engine_args: tuple, path: str | None = None):
    w, d, batch = mask.shape[0], key_idx.shape[0], bits.shape[0]
    out = torch.empty((w, batch), dtype=torch.int32, device=bits.device)
    if batch:
        bits32 = bits.to(torch.int32).contiguous()
        extra = () if path is None else (_PHILOX_PATHS[path],)
        with torch.cuda.device(bits.device):
            check(name, getattr(lib(), entry)(
                ptr(bits32), ptr(key_idx.contiguous()), ptr(mask.contiguous()),
                ptr(valid_mask.contiguous()), ptr(out), w, d, batch, col0, *engine_args,
                *extra, stream_of(bits),
            ))
        LAUNCHES[name] += 1
        if path is not None:
            LAUNCHES["philox_column" if path == "column" else "philox_tile"] += 1
            if path == "tile_4byte":
                LAUNCHES["philox_tile_4byte"] += 1
    return out


def encrypt_bits_counter(seed: int, bits: torch.Tensor, key_idx: torch.Tensor,
                         mask: torch.Tensor, valid_mask: torch.Tensor, *,
                         col0: int = 0) -> torch.Tensor:
    """Encrypt bits[batch] -> int32[W, batch] on the counter engine, as the
    stream's columns ``[col0, col0 + batch)``.

    Bit-equal to `encrypt_bits_counter_plain` (and to the JAX package's
    `encrypt_bits_counter_ref`) for every batch size.  CPU tensors take the
    plain version; CUDA tensors launch csrc/encrypt.cu or raise.
    """
    _check_encrypt_operands("encrypt_bits_counter", bits, key_idx, mask, valid_mask, col0)
    if bits.device.type == "cpu":
        return encrypt_bits_counter_plain(seed, bits, key_idx, mask, valid_mask, col0=col0)
    return _encrypt_cuda("encrypt_bits_counter", "csgn_encrypt_counter", bits, key_idx, mask,
                         valid_mask, col0, _seed_halves(seed))


def encrypt_bits_philox(seed: int, bits: torch.Tensor, key_idx: torch.Tensor,
                        mask: torch.Tensor, valid_mask: torch.Tensor, *,
                        col0: int = 0) -> torch.Tensor:
    """Encrypt bits[batch] -> int32[W, batch] on the Philox engine (K7), as
    the stream's columns ``[col0, col0 + batch)``.

    Bit-equal to `encrypt_bits_philox_plain` for every batch size.  CPU
    tensors take the plain version; CUDA tensors launch csrc/encrypt.cu on
    `philox_path`'s path or raise.
    """
    _check_encrypt_operands("encrypt_bits_philox", bits, key_idx, mask, valid_mask, col0)
    if bits.device.type == "cpu":
        return encrypt_bits_philox_plain(seed, bits, key_idx, mask, valid_mask, col0=col0)
    return _encrypt_cuda("encrypt_bits_philox", "csgn_encrypt_philox", bits, key_idx, mask,
                         valid_mask, col0, _seed_halves(seed),
                         philox_path(mask.shape[0], bits.shape[0]))


def threefry_engine_keys(key: rng.Key) -> tuple[int, ...]:
    """The threefry engine's four keys as K14 takes them, eight uint32 words:
    ``(k_words, k_rbit, k_ridx) = split(key, 3)`` (the order of
    `csgn_tpu.ops.core.encrypt_bits`), then randint's ``split(k_ridx)``;
    k_ridx itself draws nothing."""
    k_words, k_rbit, k_ridx = rng.split(key, 3)
    k1, k2 = rng.split(k_ridx)
    return (k_words.k0, k_words.k1, k_rbit.k0, k_rbit.k1, k1.k0, k1.k1, k2.k0, k2.k1)


def encrypt_bits_threefry(key: rng.Key, bits: torch.Tensor, key_idx: torch.Tensor,
                          mask: torch.Tensor, valid_mask: torch.Tensor, *, col0: int = 0,
                          total: int | None = None) -> torch.Tensor:
    """Encrypt bits[batch] -> int32[W, batch] on the JAX package's default
    engine (`csgn_tpu.ops.core.encrypt_bits` under a `jax.random` key), as
    the columns ``[col0, col0 + batch)`` of an encrypt of `total` columns
    (default ``col0 + batch``; ``total <= 2^32``).

    Bit-equal to `ops.core.encrypt_bits_threefry_plain`.  CPU tensors take
    the plain version; CUDA tensors launch K14 (csrc/encrypt.cu) or raise.
    """
    _check_encrypt_operands("encrypt_bits_threefry", bits, key_idx, mask, valid_mask, col0)
    if not isinstance(key, rng.Key):
        raise TypeError(f"encrypt_bits_threefry: key must be an rng.Key, got "
                        f"{type(key).__name__}")
    batch = bits.shape[0]
    total = col0 + batch if total is None else int(total)
    if not col0 + batch <= total <= 1 << 32:
        raise ValueError(f"encrypt_bits_threefry: need col0 + batch <= total <= 2^32, got "
                         f"col0={col0} batch={batch} total={total}")
    if bits.device.type == "cpu":
        return encrypt_bits_threefry_plain(key, bits, key_idx, mask, valid_mask, col0=col0,
                                           total=total)
    return _encrypt_cuda("encrypt_bits_threefry", "csgn_encrypt_threefry", bits, key_idx, mask,
                         valid_mask, col0, (total, *threefry_engine_keys(key)))


def _philox_cuda(seed: int, bits, key_idx, mask, valid_mask, *, path: str,
                 col0: int = 0) -> torch.Tensor:
    """K7 on the card on a forced `path`, for tests and timing.  The tile
    paths refuse W > `PHILOX_TILE_MAX_WORDS` and "tile" refuses
    batch % 4 != 0, with a CUDA error."""
    _check_encrypt_operands("encrypt_bits_philox", bits, key_idx, mask, valid_mask, col0)
    return _encrypt_cuda("encrypt_bits_philox", "csgn_encrypt_philox", bits, key_idx, mask,
                         valid_mask, col0, _seed_halves(seed), path)


def philox_streams(seed: int, batch: int, rows: int, device=None) -> torch.Tensor:
    """The Philox engine's raw stream rows, int32 ``[rows, batch]`` (the
    uint32 view), with no fix-up (K13).  For ``rows = W + 2`` these are
    exactly the draws `encrypt_bits_philox` consumes.  ``device=None`` is the
    current CUDA device; a CPU device takes the plain version."""
    device = resolve_device(device)
    if batch < 0 or rows < 0 or batch >= 1 << 32:
        raise ValueError(f"philox_streams: need 0 <= batch < 2^32 and rows >= 0, got "
                         f"batch={batch} rows={rows}")
    if device.type == "cpu":
        return philox_streams_plain(seed, batch, rows, device).to(torch.int32)
    if device.type != "cuda":
        raise ValueError(f"philox_streams: device must be cpu or cuda, got {device}")
    out = torch.empty((rows, batch), dtype=torch.int32, device=device)
    if out.numel():
        seed_lo, seed_hi = _seed_halves(seed)
        with torch.cuda.device(device):
            check("philox_streams", lib().csgn_philox_streams(
                ptr(out), rows, batch, seed_lo, seed_hi, stream_of(out)))
        LAUNCHES["philox_streams"] += 1
    return out
