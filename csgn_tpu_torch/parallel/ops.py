"""Collective homomorphic ops: every rank computes its own block.

Counterpart of `csgn_tpu.parallel.ops`.  The SPMD contract is the body of the
JAX package's `shard_map`: each rank calls the function with its own block
and gets its own block back.

  * Ciphertext chunk axes shard over the ``"c"`` mesh axis: rank i of the
    axis holds the contiguous block of chunk columns ``[i*cl, (i+1)*cl)`` of
    ``int32[W, C]``, every block the same size (callers zero-pad; zero
    chunks are decrypt-neutral, `multihost.pad_chunks_to`).
  * **Multiply** is a blockwise outer product.  With `a` chunk-sharded
    (i-blocks local) and `b` all-gathered (one collective) or passed around
    a ring (one block per step, overlapping the exchange with the block's
    product), each rank writes the (i_local, j) cross-product block.  The
    output is i-major, so it is already this rank's block of the
    chunk-sharded product: no resharding despite the growth.  The per-rank
    product is the CUDA multiply (K1/K10/K11/K6 by `kernels.mul_mode`).
  * **Decrypt** counts matches locally (K3, or K2 fused with the product)
    and crosses the mesh with one int64 ``all_reduce``; the parity is the
    total mod 2.
  * **Encrypt** shards the batch axis.  Under a `jax.random` key
    (`rng.Key`) the two functions are the JAX package's: per-rank
    ``fold_in`` streams, or one global stream whose block this rank writes
    (the engine takes a global column base, `ops.encrypt_kernels`).  Under
    an integer seed (the counter engine) a rank's words are the one-device
    encrypt's columns of its block in both.

The collectives are `torch.distributed`'s (NCCL on the card, gloo on the
CPU); they run even on an axis of size 1, so a one-rank job goes through the
same calls as a larger one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from csgn_tpu_torch.ops import dispatch, encrypt_kernels
from csgn_tpu_torch.parallel.mesh import CHUNK_AXIS, Mesh
from csgn_tpu_torch.rng import Key, fold_in
from csgn_tpu_torch.utils.metrics import op_metrics

__all__ = [
    "sharded_mul_allgather",
    "sharded_mul_broadcast",
    "sharded_mul_decrypt",
    "sharded_mul_ring",
    "sharded_decrypt_parity",
    "sharded_encrypt_bits",
    "sharded_encrypt_bits_invariant",
    "sharded_permute",
]


# `all_gather_into_tensor` under the name newer torch releases give it (the
# old name warns there); the same call either way.
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _check_block(name: str, blk: torch.Tensor, mesh: Mesh) -> None:
    if not isinstance(blk, torch.Tensor) or blk.dim() not in (2, 3):
        raise ValueError(f"{name}: a block must be an int32 [W, C] or [B, W, C] tensor")
    if blk.device != mesh.device:
        raise ValueError(f"{name}: block on {blk.device}, the mesh's ranks hold {mesh.device}")


def gather_chunks(blk: torch.Tensor, mesh: Mesh, axis: str = CHUNK_AXIS) -> torch.Tensor:
    """All-gather every rank's chunk block ``[..., W, cl]`` along `axis` into
    ``[..., W, nd*cl]``, blocks in rank order (`all_gather_into_tensor`)."""
    nd = mesh.shape[axis]
    blk = blk.contiguous()
    out = torch.empty((nd * blk.shape[0], *blk.shape[1:]), dtype=blk.dtype, device=blk.device)
    _all_gather(out, blk, group=mesh.group(axis))
    return out.view(nd, *blk.shape).movedim(0, -2).reshape(*blk.shape[:-1], nd * blk.shape[-1])


def reduce_counts(count: torch.Tensor, mesh: Mesh, axis: str = CHUNK_AXIS) -> torch.Tensor:
    """Sum int64 match counts over the ranks of `axis` (in place, returned)."""
    dist.all_reduce(count, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return count


def _record(name: str, w: int, t1: int, t2: int):
    return op_metrics().record(f"sharded.{name}", chunks_in=t1 + t2, chunks_out=t1 * t2,
                               bytes_moved=(t1 + t2 + t1 * t2) * w * 4)


def sharded_mul_allgather(a: torch.Tensor, b: torch.Tensor, mesh: Mesh,
                          axis: str = CHUNK_AXIS) -> torch.Tensor:
    """Chunk-sharded multiply via all-gather of the second operand.

    a: this rank's block ``[W, t1/nd]``; b: its block ``[W, t2/nd]``.
    Returns this rank's block ``[W, t1*t2/nd]`` of the i-major product
    (bit-identical to the same columns of `core.mul_chunks` of the whole
    operands).
    """
    _check_block("sharded_mul_allgather", a, mesh)
    _check_block("sharded_mul_allgather", b, mesh)
    nd = mesh.shape[axis]
    with _record("mul_allgather", a.shape[-2], nd * a.shape[-1], nd * b.shape[-1]):
        return dispatch.mul_chunks(a, gather_chunks(b, mesh, axis))


def sharded_mul_broadcast(a: torch.Tensor, b: torch.Tensor, mesh: Mesh,
                          axis: str = CHUNK_AXIS) -> torch.Tensor:
    """Chunk-sharded multiply with a **replicated** second operand.

    For small b (a fresh one- or two-chunk operand of a deep chain) sharding
    b buys nothing: every rank holds all of it and no collective runs.
    a: this rank's block ``[W, t1/nd]``; b: the whole ``[W, t2]``.
    """
    _check_block("sharded_mul_broadcast", a, mesh)
    _check_block("sharded_mul_broadcast", b, mesh)
    mesh.coord(axis)  # a member of the mesh
    with _record("mul_broadcast", a.shape[-2], mesh.shape[axis] * a.shape[-1], b.shape[-1]):
        return dispatch.mul_chunks(a, b)


def sharded_mul_ring(a: torch.Tensor, b: torch.Tensor, mesh: Mesh,
                     axis: str = CHUNK_AXIS) -> torch.Tensor:
    """Chunk-sharded multiply via a ring exchange of b's blocks.

    Same result as `sharded_mul_allgather`, but b circulates one block per
    step to the right-hand neighbour (`batch_isend_irecv`), so each rank
    holds two of b's blocks at a time instead of all of b, and each exchange
    runs while the block in hand is multiplied.  At step s the block in hand
    started on rank (my - s) mod nd; its product lands at column offset
    ``src * t2_blk`` of the rank's i-major ``[W, t1_blk, t2]`` output.
    """
    _check_block("sharded_mul_ring", a, mesh)
    _check_block("sharded_mul_ring", b, mesh)
    nd = mesh.shape[axis]
    my = mesh.coord(axis)
    w, t1l = a.shape
    t2b = b.shape[-1]
    t2 = nd * t2b
    group = mesh.group(axis)
    right, left = mesh.peer(axis, my + 1), mesh.peer(axis, my - 1)
    with _record("mul_ring", w, nd * t1l, t2):
        out = torch.empty((w, t1l, t2), dtype=a.dtype, device=a.device)
        cur = b.contiguous()
        for s in range(nd):
            reqs = []
            if s + 1 < nd:  # pass the block on while this step multiplies it
                nxt = torch.empty_like(cur)
                reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, cur, right, group),
                                               dist.P2POp(dist.irecv, nxt, left, group)])
            src = (my - s) % nd
            blk = dispatch.mul_chunks(a, cur).view(w, t1l, t2b)
            out[:, :, src * t2b:(src + 1) * t2b] = blk
            for r in reqs:
                r.wait()
            if reqs:
                cur = nxt
        return out.view(w, t1l * t2)


def sharded_mul_decrypt(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor, mesh: Mesh,
                        axis: str = CHUNK_AXIS):
    """Chunk-sharded FUSED multiply+decrypt: ``(product block, parity)``.

    Each rank runs the fused op (K2: the product kernel and the column-match
    pass) on its (i_local, j) block, writing its product block and its count
    na_block * nb_gathered, exact and summable; one int64 all-reduce crosses
    the mesh and the parity is the total mod 2 (an int64 0-dim tensor, the
    same on every rank).  The product is never re-read.  Bit-identical to
    `sharded_mul_allgather` then `sharded_decrypt_parity`.
    """
    _check_block("sharded_mul_decrypt", a, mesh)
    _check_block("sharded_mul_decrypt", b, mesh)
    nd = mesh.shape[axis]
    with _record("mul_decrypt", a.shape[-2], nd * a.shape[-1], nd * b.shape[-1]):
        prod, count = dispatch.mul_decrypt_count(a, gather_chunks(b, mesh, axis), mask)
        return prod, reduce_counts(count, mesh, axis) & 1


def sharded_decrypt_parity(words: torch.Tensor, mask: torch.Tensor, mesh: Mesh,
                           axis: str = CHUNK_AXIS) -> torch.Tensor:
    """Chunk-sharded decrypt: this rank's match count (K3), an int64
    all-reduce, mod 2 (an int64 0-dim tensor, the same on every rank)."""
    _check_block("sharded_decrypt_parity", words, mesh)
    with op_metrics().record("sharded.decrypt", chunks_in=words.shape[-1],
                             bytes_moved=words.shape[-1] * words.shape[-2] * 4):
        return reduce_counts(dispatch.decrypt_count(words, mask), mesh, axis) & 1


def sharded_permute(words: torch.Tensor, plan, mesh: Mesh, axis: str = CHUNK_AXIS) -> torch.Tensor:
    """Chunk-sharded permutation: the Beneš plan on this rank's block (K8).

    Bit routing is per chunk (reference src/Ciphertext.cpp:24-69), so the
    chunk axis is embarrassingly parallel: no collective, and the output is
    this rank's block of the permuted ciphertext.
    """
    _check_block("sharded_permute", words, mesh)
    mesh.coord(axis)
    with op_metrics().record("sharded.permute", chunks_in=words.shape[-1],
                             chunks_out=words.shape[-1],
                             bytes_moved=2 * words.shape[-1] * words.shape[-2] * 4):
        return dispatch.permute(words, plan)


def _encrypt_block(name: str, rng, bits, key_indices, mask, valid_mask, mesh: Mesh, axis: str,
                   invariant: bool) -> torch.Tensor:
    if bits.device != mesh.device:
        raise ValueError(f"{name}: bits on {bits.device}, the mesh's ranks hold {mesh.device}")
    bl, coord = int(bits.shape[0]), mesh.coord(axis)
    with op_metrics().record("sharded.encrypt", chunks_out=bl,
                             bytes_moved=bl * mask.shape[0] * 4):
        if not isinstance(rng, Key):
            return encrypt_kernels.encrypt_bits_counter(rng, bits, key_indices, mask,
                                                        valid_mask, col0=coord * bl)
        if invariant:
            key, col0, total = rng, coord * bl, mesh.shape[axis] * bl
        else:
            key, col0, total = fold_in(rng, coord), 0, bl
        return encrypt_kernels.encrypt_bits_threefry(key, bits, key_indices, mask, valid_mask,
                                                     col0=col0, total=total)


def sharded_encrypt_bits(rng, bits: torch.Tensor, key_indices: torch.Tensor,
                         mask: torch.Tensor, valid_mask: torch.Tensor, n: int, d: int,
                         mesh: Mesh, axis: str = CHUNK_AXIS) -> torch.Tensor:
    """Batch-sharded fresh encryption: this rank's block of bits
    ``[batch/nd]`` -> its block of words ``int32[W, batch/nd]``.

    With an `rng.Key`, the JAX package's `sharded_encrypt_bits` bit for bit:
    rank i of the axis encrypts its block on the default engine (K14) under
    ``fold_in(rng, i)``, as the JAX `shard_map` body does with
    ``fold_in(rng, axis_index)``, so the words depend on the rank count.
    With an integer seed, the counter engine (K4) on the global columns
    ``[i*bl, (i+1)*bl)``: the one-device ``encrypt_batch(bits, seed)``'s
    columns of the block, on any number of ranks.
    `key_indices`, `mask` and `valid_mask` are `SecretKey.encrypt_operands`;
    `n` and `d` are kept for the JAX signature.
    """
    return _encrypt_block("sharded_encrypt_bits", rng, bits, key_indices, mask, valid_mask,
                          mesh, axis, invariant=False)


def sharded_encrypt_bits_invariant(rng, bits: torch.Tensor, key_indices: torch.Tensor,
                                   mask: torch.Tensor, valid_mask: torch.Tensor, n: int, d: int,
                                   mesh: Mesh, axis: str = CHUNK_AXIS) -> torch.Tensor:
    """Batch-sharded encryption whose output is **mesh-invariant**: this
    rank's block of the one-device encrypt.

    With an `rng.Key`, the JAX package's `sharded_encrypt_bits_invariant`
    bit for bit (one global threefry array of the whole batch, as the JAX
    function draws under jit and shardings): rank i writes the columns
    ``[i*bl, (i+1)*bl)`` of ``encrypt_batch(all bits, rng)`` (K14).  With
    an integer seed, the same as `sharded_encrypt_bits` (the counter engine
    is mesh-invariant already).
    """
    return _encrypt_block("sharded_encrypt_bits_invariant", rng, bits, key_indices, mask,
                          valid_mask, mesh, axis, invariant=True)
