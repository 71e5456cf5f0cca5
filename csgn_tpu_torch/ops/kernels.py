"""CUDA kernels for the hot ops (word-major ``int32[W, C]``), with their plain
torch versions.

  * K1 `mul_chunks` — chunk cross-product AND (csrc/mul.cu; replaces
    csgn_tpu/ops/kernels.py `mul_chunks_pallas`).
  * K2 `mul_decrypt` — the product and its decrypt count (replaces
    `mul_decrypt_pallas`): `mul_chunks`' own product kernel followed, on the
    same stream, by the column-match pass of csrc/mul.cu.
    A product chunk (i, j) matches iff a's chunk i and b's chunk j both
    match, so the pass tests a's t1 and b's t2 columns on the mask's nonzero
    words and writes ``count = na * nb`` per element (exact int64; written,
    not accumulated, so the count needs no zeroed buffer).  Its launches
    count under ``LAUNCHES["mul_count"]`` (``"mul_count_batched"`` for
    batches), beside the product's under the wrapper's own key.
  * The same two wrappers launch csrc/mul.cu's product in one of three modes,
    picked by `mul_mode` from the shapes and the output's alignment: "aligned"
    (K1/K2), "unaligned" (any t1*t2; does the job of `mul_chunks_pallas_grouped`
    K10, `mul_chunks_pallas_tiled_ragged` K11a and, with the pass,
    `mul_decrypt_pallas_tiled_ragged` K11b, with no pad chunks) and
    "tiled", b streamed tile by tile when b is larger than
    `B_STREAM_BYTES` (`mul_chunks_pallas_tiled` K6a, with the pass
    `mul_decrypt_pallas_tiled` K6b).  Every mode writes the canonical i-major
    product.
  * K3 `decrypt_parity` / `chunk_matches` — streaming eq-all against the key
    mask, as a count or per chunk (csrc/decrypt.cu; replaces
    `decrypt_parity_pallas`).
  * K5 `fill_anchor` — a constant fill of the product's shape at the card's
    write floor (flat 16-byte streaming stores over the whole buffer), the
    write speed-of-light anchor that K1/K2 are timed against: anchor / K1 is
    K1's share of the write floor (csrc/fill.cu; replaces
    `fill_anchor_pallas`).

Every wrapper takes word-major ``[W, C]`` words or a batch ``[B, W, C]``
(one kernel launch for the whole batch, the element from the grid; the JAX
package vmaps the same kernels).  Counts and parities are then per element.

Routing is by the tensors' device: a CPU tensor goes to the plain version, a
CUDA tensor launches the kernel or raises.  There is no fallback and no size
threshold.  Counts come back as int64 device tensors and parities as
``count & 1``; nothing here synchronizes with the host.  Each launch adds one
to ``LAUNCHES[<wrapper name>]``, or to ``LAUNCHES[<wrapper name>_batched]``
for batched words; the multiply's unaligned and tiled modes count under
``<wrapper name>_unaligned`` and ``<wrapper name>_tiled`` (``_batched``
appended for batches), and each multiply launch also bumps the
``op_metrics()`` counter ``<wrapper name>.<mode>``.  While spans are
recorded (`utils.metrics`), each CUDA body, from the output's allocation
to the count, is the span ``launch.<wrapper name>``.
"""

from __future__ import annotations

import torch

from csgn_tpu_torch._device import resolve_device
from csgn_tpu_torch.ops import core
from csgn_tpu_torch.ops._build import LAUNCHES, check, grids, lib, ptr, stream_of
from csgn_tpu_torch.utils.metrics import op_metrics

__all__ = [
    "LAUNCHES",
    "B_STREAM_BYTES",
    "mul_mode",
    "mul_chunks",
    "mul_chunks_plain",
    "mul_decrypt",
    "mul_decrypt_plain",
    "decrypt_parity",
    "decrypt_parity_plain",
    "chunk_matches",
    "chunk_matches_plain",
    "fill_anchor",
    "fill_anchor_plain",
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
    count = core.chunk_matches(prod, mask).sum(dim=-1)
    return prod, (count if return_count else count & 1)


# ---------------------------------------------------------------------------
# Argument checks (the kernels take exactly this)
# ---------------------------------------------------------------------------


def _check_operands(name: str, words: tuple, mask: torch.Tensor | None = None) -> None:
    """Words are int32 ``[W, *]``, or all ``[B, W, *]``, with one B and W;
    the mask (if any) int32 ``[W]``; all contiguous and on one CPU or CUDA
    device."""
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
    lead = tuple(words[0].shape[:-1])
    if len(lead) not in (1, 2) or any(tuple(t.shape[:-1]) != lead for t in words):
        raise ValueError(f"{name}: words must be [W, chunks] or [B, W, chunks] with one B "
                         f"and W, got {[tuple(t.shape) for t in words]}")
    w = lead[-1]
    if mask is not None and tuple(mask.shape) != (w,):
        raise ValueError(f"{name}: mask must be [W={w}], got {tuple(mask.shape)}")


# ---------------------------------------------------------------------------
# K1 / K2: multiply, and multiply fused with decrypt
# ---------------------------------------------------------------------------


def _counted(name: str, words: torch.Tensor) -> str:
    return name if words.dim() == 2 else name + "_batched"


# b (one element's [W, t2] operand) larger than this streams tile by tile:
# the i-major walk reads all of b once per a-column, free while b stays in
# the H100's 50 MB L2.  On an H100 (t1 = 16) the two walks broke even at
# b = 20 MiB and the streamed one took 22 % less time at 40 MiB.
B_STREAM_BYTES = 25 << 20

# Mode -> csgn_mul's mode code.
_MODE_CODES = {"aligned": 0, "unaligned": 1, "tiled": 2}


def mul_mode(w: int, t1: int, t2: int, base_aligned: bool) -> str:
    """The csrc/mul.cu mode for a [W,t1] x [W,t2] product (per element of a
    batch) whose output starts at a 16-byte-aligned address iff
    `base_aligned`:

      * "tiled" when b holds more than `B_STREAM_BYTES`;
      * "aligned" when every row start r*t1*t2 is a multiple of 4 words and
        the base is aligned (then every element base e*W*t1*t2 of a batch is
        too, so the batch size never changes the mode);
      * "unaligned" otherwise.
    """
    if w * t2 * 4 > B_STREAM_BYTES:
        return "tiled"
    if base_aligned and (t1 * t2) % 4 == 0:
        return "aligned"
    return "unaligned"


def _mul_cuda(name: str, a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor | None):
    """Launch csrc/mul.cu in `mul_mode`'s mode, under the span
    ``launch.<name>``."""
    metrics = op_metrics()
    with metrics.span(f"launch.{name}"):
        *lead, w, t1 = a.shape
        t2 = b.shape[-1]
        out = torch.empty((*lead, w, t1 * t2), dtype=torch.int32, device=a.device)
        count = scratch = None
        if mask is not None:  # the pass writes every count; an empty product has count 0
            alloc = torch.empty if out.numel() else torch.zeros
            count = alloc(lead, dtype=torch.int64, device=a.device)
        if out.numel():
            mode = mul_mode(w, t1, t2, out.data_ptr() % 16 == 0)
            batch = lead[0] if lead else 1
            if mask is not None:
                scratch = torch.empty((batch, 2), dtype=torch.int64, device=a.device)
            with torch.cuda.device(a.device):
                check(name, lib().csgn_mul(
                    ptr(a), ptr(b), ptr(mask), ptr(out), ptr(count), ptr(scratch), batch, w,
                    t1, t2, _MODE_CODES[mode], stream_of(a)
                ))
            ragged = mode in ("unaligned", "tiled")
            LAUNCHES[_counted(f"{name}_{mode}" if ragged else name, a)] += grids(batch)
            if mask is not None:
                LAUNCHES[_counted("mul_count", a)] += grids(batch)
            metrics.count(f"{name}.{mode}")
        return out, count


def mul_chunks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross-product AND: [W,t1] x [W,t2] -> [W, t1*t2], out index i*t2+j
    (reference src/Ciphertext.cpp:159), for any t1, t2; batched
    [B,W,t1] x [B,W,t2] -> [B,W,t1*t2] element by element."""
    _check_operands("mul_chunks", (a, b))
    if a.device.type == "cpu":
        return mul_chunks_plain(a, b)
    return _mul_cuda("mul_chunks", a, b, None)[0]


def mul_decrypt(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor, *,
                return_count: bool = False):
    """Fused multiply + decrypt: ``(prod [W, t1*t2], parity)`` from the
    product kernel and the column-match pass, one C call (batched:
    ``(prod [B, W, t1*t2], parity int64[B])``).

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
    with op_metrics().span(f"launch.{name}"):
        *lead, w, c = words.shape
        if per_chunk:
            out = torch.empty((*lead, c), dtype=torch.int32, device=words.device)
        else:
            out = torch.zeros(lead, dtype=torch.int64, device=words.device)
        if words.numel():
            vec = 4 if c % 4 == 0 and words.data_ptr() % 16 == 0 else 1
            batch = lead[0] if lead else 1
            with torch.cuda.device(words.device):
                check(name, lib().csgn_decrypt(
                    ptr(words), ptr(mask), ptr(out), batch, w, c, int(per_chunk), vec,
                    stream_of(words)
                ))
            LAUNCHES[_counted(name, words)] += grids(batch)
        return out


def decrypt_parity(words: torch.Tensor, mask: torch.Tensor, *,
                   return_count: bool = False) -> torch.Tensor:
    """Decrypt [W, chunks] with mask [W] -> parity bit (int64 0-dim tensor);
    batched [B, W, chunks] -> int64[B].  ``return_count=True`` returns the
    exact int64 match count instead of the parity (the summable form a
    sharded decrypt reduces across ranks)."""
    _check_operands("decrypt_parity", (words,), mask)
    if words.device.type == "cpu":
        if return_count:
            return core.chunk_matches(words, mask).sum(dim=-1)
        return decrypt_parity_plain(words, mask)
    count = _decrypt_cuda("decrypt_parity", words, mask, False)
    return count if return_count else count & 1


def chunk_matches(words: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-chunk decrypt bits of [W, chunks] -> int32[chunks] of 0/1
    (batched [B, W, chunks] -> int32[B, chunks])."""
    _check_operands("chunk_matches", (words,), mask)
    if words.device.type == "cpu":
        return chunk_matches_plain(words, mask)
    return _decrypt_cuda("chunk_matches", words, mask, True)


# ---------------------------------------------------------------------------
# K5: the write anchor
# ---------------------------------------------------------------------------


def _anchor_value(seed: int) -> int:
    """The seed's low 32 bits as the int32 view."""
    v = int(seed) & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def fill_anchor_plain(seed: int, t1: int, t2: int, w: int, device=None) -> torch.Tensor:
    """int32 ``[W, t1*t2]`` filled with the seed's low 32 bits (plain torch)."""
    return torch.full((w, t1 * t2), _anchor_value(seed), dtype=torch.int32,
                      device=resolve_device(device))


def fill_anchor(seed: int, t1: int, t2: int, w: int, device=None) -> torch.Tensor:
    """The write anchor: int32 ``[W, t1*t2]`` filled with the seed's low 32
    bits, written flat at the card's write floor with no pad columns (the JAX
    fill pads t1 up to its block).  ``device=None`` is the current CUDA device; a CPU
    device takes the plain version, a CUDA device launches csrc/fill.cu."""
    device = resolve_device(device)
    if min(t1, t2, w) < 0:
        raise ValueError(f"fill_anchor: negative shape t1={t1} t2={t2} w={w}")
    if device.type == "cpu":
        return fill_anchor_plain(seed, t1, t2, w, device)
    if device.type != "cuda":
        raise ValueError(f"fill_anchor: device must be cpu or cuda, got {device}")
    with op_metrics().span("launch.fill_anchor"):
        out = torch.empty((w, t1 * t2), dtype=torch.int32, device=device)
        if out.numel():
            with torch.cuda.device(device):
                check("fill_anchor", lib().csgn_fill_anchor(
                    ptr(out), int(seed) & 0xFFFFFFFF, w, t1 * t2, stream_of(out)))
            LAUNCHES["fill_anchor"] += 1
        return out
