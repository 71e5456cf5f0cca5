"""CUDA kernels for the hot ops (word-major ``int32[W, C]``), with their plain
torch versions.

  * K1 `mul_chunks` — chunk cross-product AND (csrc/mul.cu; replaces
    csgn_tpu/ops/kernels.py `mul_chunks_pallas`).
  * K2 `mul_decrypt` — K1 plus the product's decrypt count in the same pass
    (csrc/mul.cu with the count on; replaces `mul_decrypt_pallas`).
  * K3 `decrypt_parity` / `chunk_matches` — streaming eq-all against the key
    mask, as a count or per chunk (csrc/decrypt.cu; replaces
    `decrypt_parity_pallas`).

Routing is by the tensors' device: a CPU tensor goes to the plain version, a
CUDA tensor launches the kernel or raises.  There is no fallback and no size
threshold.  Counts come back as int64 device tensors and parities as
``count & 1``; nothing here synchronizes with the host.  Each launch adds one
to ``LAUNCHES[<wrapper name>]``.
"""

from __future__ import annotations

import torch

from csgn_tpu_torch.ops import core
from csgn_tpu_torch.ops._build import LAUNCHES, check, lib, ptr, stream_of

__all__ = [
    "LAUNCHES",
    "mul_chunks",
    "mul_chunks_plain",
    "mul_decrypt",
    "mul_decrypt_plain",
    "decrypt_parity",
    "decrypt_parity_plain",
    "chunk_matches",
    "chunk_matches_plain",
]


# ---------------------------------------------------------------------------
# Plain torch versions (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------

mul_chunks_plain = core.mul_chunks
decrypt_parity_plain = core.decrypt_parity
chunk_matches_plain = core.chunk_matches


def mul_decrypt_plain(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor, *,
                      return_count: bool = False):
    """Staged product + decrypt: ``(prod, parity)`` or ``(prod, count)``."""
    prod = core.mul_chunks(a, b)
    count = core.chunk_matches(prod, mask).sum()
    return prod, (count if return_count else count & 1)


# ---------------------------------------------------------------------------
# Argument checks (the kernels take exactly this)
# ---------------------------------------------------------------------------


def _check_operands(name: str, words: tuple, mask: torch.Tensor | None = None) -> None:
    """Words are 2-D int32 ``[W, *]`` with one W, the mask (if any) int32
    ``[W]``; all contiguous and on one CPU or CUDA device."""
    tensors = list(words) + ([mask] if mask is not None else [])
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 words (the uint32 view), got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda") or any(t.device != dev for t in tensors):
        raise ValueError(
            f"{name}: operands must share one cpu or cuda device, got "
            f"{[str(t.device) for t in tensors]}"
        )
    w = words[0].shape[0] if words[0].dim() == 2 else -1
    if any(t.dim() != 2 or t.shape[0] != w for t in words):
        raise ValueError(f"{name}: words must be [W, chunks] with one W, got "
                         f"{[tuple(t.shape) for t in words]}")
    if mask is not None and tuple(mask.shape) != (w,):
        raise ValueError(f"{name}: mask must be [W={w}], got {tuple(mask.shape)}")


# ---------------------------------------------------------------------------
# K1 / K2: multiply, and multiply fused with decrypt
# ---------------------------------------------------------------------------


def _mul_cuda(name: str, a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor | None):
    w, t1 = a.shape
    t2 = b.shape[1]
    out = torch.empty((w, t1 * t2), dtype=torch.int32, device=a.device)
    count = None if mask is None else torch.zeros((), dtype=torch.int64, device=a.device)
    if out.numel():
        vec = 4 if (t1 * t2) % 4 == 0 else 1   # out is fresh, so 16-byte aligned
        with torch.cuda.device(a.device):
            check(name, lib().csgn_mul(
                ptr(a), ptr(b), ptr(mask), ptr(out), ptr(count), w, t1, t2, vec, stream_of(a)
            ))
        LAUNCHES[name] += 1
    return out, count


def mul_chunks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross-product AND: [W,t1] x [W,t2] -> [W, t1*t2], out index i*t2+j
    (reference src/Ciphertext.cpp:159), for any t1, t2."""
    _check_operands("mul_chunks", (a, b))
    if a.device.type == "cpu":
        return mul_chunks_plain(a, b)
    return _mul_cuda("mul_chunks", a, b, None)[0]


def mul_decrypt(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor, *,
                return_count: bool = False):
    """Fused multiply + decrypt: ``(prod [W, t1*t2], parity)`` in one pass.

    ``return_count=True`` returns the exact int64 match count instead of the
    parity (the JAX kernel's int32 accumulator keeps only the low bit exact).
    Bit-exact to ``decrypt_parity(mul_chunks(a, b), mask)``.
    """
    _check_operands("mul_decrypt", (a, b), mask)
    if a.device.type == "cpu":
        return mul_decrypt_plain(a, b, mask, return_count=return_count)
    prod, count = _mul_cuda("mul_decrypt", a, b, mask)
    return prod, (count if return_count else count & 1)


# ---------------------------------------------------------------------------
# K3: decrypt (count mode and per-chunk mode)
# ---------------------------------------------------------------------------


def _decrypt_cuda(name: str, words: torch.Tensor, mask: torch.Tensor, per_chunk: bool):
    w, c = words.shape
    if per_chunk:
        out = torch.empty((c,), dtype=torch.int32, device=words.device)
    else:
        out = torch.zeros((), dtype=torch.int64, device=words.device)
    if c:
        vec = 4 if c % 4 == 0 and words.data_ptr() % 16 == 0 else 1
        with torch.cuda.device(words.device):
            check(name, lib().csgn_decrypt(
                ptr(words), ptr(mask), ptr(out), w, c, int(per_chunk), vec, stream_of(words)
            ))
        LAUNCHES[name] += 1
    return out


def decrypt_parity(words: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Decrypt [W, chunks] with mask [W] -> parity bit (int64 0-dim tensor)."""
    _check_operands("decrypt_parity", (words,), mask)
    if words.device.type == "cpu":
        return decrypt_parity_plain(words, mask)
    return _decrypt_cuda("decrypt_parity", words, mask, False) & 1


def chunk_matches(words: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-chunk decrypt bits of [W, chunks] -> int32[chunks] of 0/1."""
    _check_operands("chunk_matches", (words,), mask)
    if words.device.type == "cpu":
        return chunk_matches_plain(words, mask)
    return _decrypt_cuda("chunk_matches", words, mask, True)
