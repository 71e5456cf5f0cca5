"""Deep-circuit pipelines: multiplication chains with growth budgeting.

Counterpart of `csgn_tpu.pipeline`.  Chunk counts multiply under homomorphic
multiply (the scheme is *bounded*), so deep chains are a memory problem
before they are a kernel problem:

  * `mul_chain` — the left-fold product of many ciphertexts, bit-identical
    to folding with `*` one step at a time (canonical i-major order at every
    step);
  * `mul_chain_decrypt` — the same fold with the final multiply fused with
    the decrypt (`dispatch.mul_decrypt`), so the largest product is written
    once and never re-read;
  * `chain_chunks` — closed-form growth accounting, for budgeting before
    running (and for deciding where the key holder should
    `SecretKey.recrypt`);
  * `mul_chain_sharded` / `mul_chain_sharded_decrypt` — the same folds with
    the accumulator chunk-sharded over a mesh of ranks (`parallel`): each
    rank holds and grows its own block.

Both chains refuse, before anything is allocated, a fold whose peak live
intermediates exceed ``budget_bytes``.  The default budget is 3/4 of the
card's memory for inputs on a CUDA device (the share the JAX package leaves
its chain), and the JAX package's constant `HBM_BUDGET_BYTES` on the CPU, so
the CPU tests see the same refusals as the JAX package.
"""

from __future__ import annotations

import torch

from csgn_tpu_torch.ciphertext import Ciphertext
from csgn_tpu_torch.ops import dispatch
from csgn_tpu_torch.parallel.mesh import CHUNK_AXIS, Mesh
from csgn_tpu_torch.parallel.multihost import shard_ciphertext
from csgn_tpu_torch.parallel.ops import (sharded_decrypt_parity, sharded_mul_allgather,
                                         sharded_mul_broadcast, sharded_mul_decrypt)
from csgn_tpu_torch.plaintext import Plaintext

__all__ = [
    "HBM_BUDGET_BYTES",
    "default_budget_bytes",
    "chain_chunks",
    "mul_chain",
    "mul_chain_decrypt",
    "mul_chain_sharded",
    "mul_chain_sharded_decrypt",
]

# The JAX package's default chain budget (csgn_tpu/pipeline.py:48): the
# default for inputs on the CPU.
HBM_BUDGET_BYTES = 12 << 30

# Marks "the default budget of the inputs' device" in keyword defaults.
DEFAULT = object()


def default_budget_bytes(device) -> int:
    """Default budget for chain intermediates on `device`: 3/4 of a CUDA
    device's memory, `HBM_BUDGET_BYTES` elsewhere."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory * 3 // 4
    return HBM_BUDGET_BYTES


def chain_chunks(chunk_counts: list[int]) -> int:
    """Chunks of fold(*, counts): product of all counts."""
    out = 1
    for c in chunk_counts:
        out *= c
    return out


def _check_contexts(cts: list[Ciphertext]) -> None:
    if not cts:
        raise ValueError("empty chain")
    for ct in cts[1:]:
        if ct.ctx != cts[0].ctx:
            raise ValueError("context mismatch in chain")


def _check_chain_budget(cts: list[Ciphertext], budget_bytes) -> None:
    """Closed-form peak-live-bytes check of the fold: during step k the
    input accumulator and its product coexist (acc * (1 + t_k) chunks)."""
    if budget_bytes is DEFAULT:
        budget_bytes = default_budget_bytes(cts[0].device)
    counts = [ct.chunks for ct in cts]
    if budget_bytes is None or len(counts) < 2:
        return
    acc = counts[0]
    peak = acc
    for t in counts[1:]:
        peak = max(peak, acc * (1 + t))
        acc *= t
    need = cts[0].ctx.chunk_count_bytes(peak)
    if need > budget_bytes:
        raise ValueError(
            f"chain intermediates peak at ~{need / 2**30:.2f} GiB "
            f"({peak} live chunks) > budget {budget_bytes / 2**30:.2f} GiB; "
            "reset growth mid-chain (SecretKey.recrypt), or decrypt without "
            "materializing (SecretKey.decrypt_circuit).  Pass budget_bytes=None "
            "to override."
        )


def mul_chain(cts: list[Ciphertext], *, budget_bytes: int | None = DEFAULT) -> Ciphertext:
    """Left-fold homomorphic product, bit-identical to folding with `*`.

    Raises if the fold's peak live intermediates exceed ``budget_bytes``
    (default: `default_budget_bytes` of the inputs' device; None disables
    the check).
    """
    _check_contexts(cts)
    _check_chain_budget(cts, budget_bytes)
    # Canonical inputs (a no-op for fresh ciphertexts): the fold writes the
    # reference i-major order, so its result carries no tag.
    wts = [ct.canonical().wt for ct in cts]
    acc = wts[0]
    for wt in wts[1:]:
        acc = dispatch.mul_chunks(acc, wt)
    return Ciphertext(acc, cts[0].ctx)


def mul_chain_decrypt(
    cts: list[Ciphertext], sk, *, budget_bytes: int | None = DEFAULT
) -> tuple[Ciphertext, Plaintext]:
    """`mul_chain` with the FINAL multiply fused with the decrypt: the
    largest product is written once and never re-read.  Returns
    ``(product, Dec(product))``, bit-exact to
    ``(mul_chain(cts), sk.decrypt(mul_chain(cts)))``; same budget check.
    """
    _check_contexts(cts)
    if sk.ctx != cts[0].ctx:
        raise ValueError("secret key context mismatch")
    _check_chain_budget(cts, budget_bytes)
    mask = sk.mask_words
    wts = [ct.canonical().wt for ct in cts]
    acc = wts[0]
    for wt in wts[1:-1]:
        acc = dispatch.mul_chunks(acc, wt)
    if len(cts) > 1:
        words, parity = dispatch.mul_decrypt(acc, wts[-1], mask)
    else:
        words, parity = acc, dispatch.decrypt_parity(acc, mask)
    return Ciphertext(words, cts[0].ctx), Plaintext(int(parity))


def _sharded_step(acc: torch.Tensor, ct: Ciphertext, mesh: Mesh, axis: str) -> torch.Tensor:
    """One fold step on this rank's accumulator block: an operand whose chunk
    count divides the axis is cut into blocks and all-gathered, any other
    stays replicated (the JAX package's choice per operand)."""
    ct = ct.canonical()
    if ct.chunks % mesh.shape[axis] == 0:
        return sharded_mul_allgather(acc, shard_ciphertext(ct, mesh, axis).wt, mesh, axis)
    return sharded_mul_broadcast(acc, ct.wt.to(mesh.device), mesh, axis)


def mul_chain_sharded(cts: list[Ciphertext], mesh: Mesh, axis: str = CHUNK_AXIS) -> Ciphertext:
    """`mul_chain` with the accumulator chunk-sharded over the mesh.

    ``cts[0]`` is this rank's block of the first operand (every rank's block
    the same size, as `parallel.shard_ciphertext` cuts it); the later
    operands are whole ciphertexts that every rank holds, typically small
    against the accumulator.  An operand whose chunk count divides the axis
    goes through `sharded_mul_allgather` (each rank contributes its block),
    any other through `sharded_mul_broadcast` (no collective).  The i-major
    output keeps the accumulator contiguously sharded after every step.
    Returns this rank's block of the product.
    """
    _check_contexts(cts)
    acc = cts[0].canonical().wt
    for ct in cts[1:]:
        acc = _sharded_step(acc, ct, mesh, axis)
    return Ciphertext(acc, cts[0].ctx)


def mul_chain_sharded_decrypt(cts: list[Ciphertext], sk, mesh: Mesh,
                              axis: str = CHUNK_AXIS) -> tuple[Ciphertext, Plaintext]:
    """`mul_chain_sharded` with the final step fused with the decrypt
    (`parallel.sharded_mul_decrypt`): each rank writes its block of the
    final product once and never re-reads it, and one int64 all-reduce
    carries the parity out.  Where the last operand's chunk count does not
    divide the axis, the last step is a broadcast multiply and the decrypt a
    sharded K3 count.  Returns ``(this rank's block, the parity)``, the
    parity the same on every rank.
    """
    _check_contexts(cts)
    if sk.ctx != cts[0].ctx:
        raise ValueError("secret key context mismatch")
    mask = sk.mask_words.to(mesh.device)
    if len(cts) == 1:
        return cts[0], Plaintext(int(sharded_decrypt_parity(cts[0].wt, mask, mesh, axis)))
    acc = mul_chain_sharded(cts[:-1], mesh, axis).wt
    last = cts[-1].canonical()
    if last.chunks % mesh.shape[axis] == 0:
        words, parity = sharded_mul_decrypt(acc, shard_ciphertext(last, mesh, axis).wt, mask,
                                            mesh, axis)
    else:
        words = sharded_mul_broadcast(acc, last.wt.to(mesh.device), mesh, axis)
        parity = sharded_decrypt_parity(words, mask, mesh, axis)
    return Ciphertext(words, cts[0].ctx), Plaintext(int(parity))
