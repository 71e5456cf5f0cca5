"""K4: batched encrypt on the counter engine, with its plain torch version.

Counterpart of `csgn_tpu.ops.encrypt_pallas.encrypt_bits_counter`: the only
encrypt engine of the JAX package whose output bits are defined independently
of the backend, so the port reproduces them exactly — the same (seed, key,
bits) give the same ciphertext words on the CPU, the TPU and the GPU, for any
batch size (the counters are global columns).

Stream spec (csgn_tpu/ops/encrypt_pallas.py:152-157): R = W + 2 rows rounded
up to even, R2 = R // 2.  For pair k in [0, R2) and column j,
``(y0, y1) = threefry2x32(key=(seed_lo, seed_hi), ctr=(k, j))``; stream row k
is y0 and row R2 + k is y1.  Rows [0, W) are the chunk words, row W selects
the broken secret index (``% d``, unsigned) and row W + 1 gives the bit-0 coin.

The CUDA kernel is csrc/encrypt.cu.  The plain version runs the uint32
arithmetic in int64 masked to 32 bits (torch has no uint32 add, shift or
``%``) and wraps the result to the int32 view at the end.
"""

from __future__ import annotations

import torch

from csgn_tpu_torch.ops._build import LAUNCHES, check, lib, ptr, stream_of

__all__ = [
    "LAUNCHES",
    "threefry2x32",
    "encrypt_bits_counter",
    "encrypt_bits_counter_plain",
]

_M32 = 0xFFFFFFFF
_TF_ROT = (13, 15, 26, 6, 17, 29, 16, 24)


def threefry2x32(k0: int, k1: int, c0: torch.Tensor, c1: torch.Tensor):
    """Threefry-2x32-20 (Random123) on int64 tensors holding uint32 counters;
    returns (y0, y1) as int64 in [0, 2^32)."""
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


def _seed_halves(seed: int) -> tuple[int, int]:
    return int(seed) & _M32, (int(seed) >> 32) & _M32


def encrypt_bits_counter_plain(
    seed: int,
    bits: torch.Tensor,
    key_idx: torch.Tensor,
    mask: torch.Tensor,
    valid_mask: torch.Tensor,
) -> torch.Tensor:
    """Encrypt bits[batch] -> int32[W, batch] (plain torch, any device).

    Mirrors `_encrypt_derive` (csgn_tpu/ops/encrypt_pallas.py:193-214):
    bit 1 ORs in the mask; bit 0 breaks secret position key[r], forcing it to
    0 if the other secret bits are all 1 and to the coin otherwise; bits at
    positions >= n are zero.
    """
    dev = bits.device
    w, d, batch = mask.shape[0], key_idx.shape[0], bits.shape[0]
    r2 = (w + 3) // 2
    seed_lo, seed_hi = _seed_halves(seed)
    c0 = torch.arange(r2, dtype=torch.int64, device=dev)[:, None].expand(r2, batch)
    c1 = torch.arange(batch, dtype=torch.int64, device=dev)[None, :].expand(r2, batch)
    y0, y1 = threefry2x32(seed_lo, seed_hi, c0, c1)
    stream = torch.cat([y0, y1])                                  # [R, batch]

    m = (mask.to(torch.int64) & _M32)[:, None]
    words = stream[:w] & (valid_mask.to(torch.int64) & _M32)[:, None]
    ones_words = words | m
    pos = key_idx.to(torch.int64)[stream[w] % d]                  # [batch]
    r_bit = torch.ones_like(pos) << (31 - pos % 32)
    rows = torch.arange(w, dtype=torch.int64, device=dev)[:, None]
    onehot = torch.where(rows == (pos // 32)[None, :], r_bit[None, :], 0)
    mask_wo = m & ~onehot
    others_all_one = ((words & mask_wo) == mask_wo).all(dim=0)
    forced = torch.where(others_all_one, 0, stream[w + 1] & 1)
    zero_words = (words & ~onehot) | (onehot * forced[None, :])
    is_one = ((bits.to(torch.int64) & 1) == 1)[None, :]
    # Values are in [0, 2^32); the int64 -> int32 cast wraps them to the view.
    return torch.where(is_one, ones_words, zero_words).to(torch.int32)


def _check_encrypt_operands(bits, key_idx, mask, valid_mask) -> None:
    for name, t in (("bits", bits), ("key_idx", key_idx), ("mask", mask),
                    ("valid_mask", valid_mask)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"encrypt_bits_counter: {name} must be a torch.Tensor")
        if t.dim() != 1:
            raise ValueError(f"encrypt_bits_counter: {name} must be 1-D, got {tuple(t.shape)}")
        if t.device != bits.device or t.device.type not in ("cpu", "cuda"):
            raise ValueError("encrypt_bits_counter: operands must share one cpu or cuda device")
    for name, t in (("key_idx", key_idx), ("mask", mask), ("valid_mask", valid_mask)):
        if t.dtype != torch.int32:
            raise TypeError(f"encrypt_bits_counter: {name} must be int32, got {t.dtype}")
    if bits.dtype.is_floating_point or bits.dtype.is_complex:
        raise TypeError(f"encrypt_bits_counter: bits must be integer or bool, got {bits.dtype}")
    if mask.shape != valid_mask.shape:
        raise ValueError("encrypt_bits_counter: mask and valid_mask must both be [W]")
    if key_idx.shape[0] < 1:
        raise ValueError("encrypt_bits_counter: need at least one key index")
    if bits.shape[0] >= 1 << 32:
        raise ValueError("encrypt_bits_counter: batch must be < 2^32 (uint32 counters)")


def encrypt_bits_counter(
    seed: int,
    bits: torch.Tensor,
    key_idx: torch.Tensor,
    mask: torch.Tensor,
    valid_mask: torch.Tensor,
) -> torch.Tensor:
    """Encrypt bits[batch] -> int32[W, batch] on the counter engine.

    Bit-equal to `encrypt_bits_counter_plain` (and to the JAX package's
    `encrypt_bits_counter_ref`) for every batch size.  CPU tensors take the
    plain version; CUDA tensors launch csrc/encrypt.cu or raise.
    """
    _check_encrypt_operands(bits, key_idx, mask, valid_mask)
    if bits.device.type == "cpu":
        return encrypt_bits_counter_plain(seed, bits, key_idx, mask, valid_mask)
    w, d, batch = mask.shape[0], key_idx.shape[0], bits.shape[0]
    out = torch.empty((w, batch), dtype=torch.int32, device=bits.device)
    if batch:
        bits32 = bits.to(torch.int32).contiguous()
        seed_lo, seed_hi = _seed_halves(seed)
        with torch.cuda.device(bits.device):
            check("encrypt_bits_counter", lib().csgn_encrypt_counter(
                ptr(bits32), ptr(key_idx.contiguous()), ptr(mask.contiguous()),
                ptr(valid_mask.contiguous()), ptr(out), w, d, batch, seed_lo, seed_hi,
                stream_of(bits),
            ))
        LAUNCHES["encrypt_bits_counter"] += 1
    return out
