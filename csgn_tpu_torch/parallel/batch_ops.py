"""2-D sharded batched ops: batch axis x chunk axis over a ("b", "c") mesh.

Counterpart of `csgn_tpu.parallel.batch_ops`.  A `CiphertextBatch` payload
``int32[B, W, C]`` is laid out as the JAX package's ``P("b", None, "c")``:
rank (i, j) of the mesh holds elements ``[i*Bl, (i+1)*Bl)`` and chunk columns
``[j*Cl, (j+1)*Cl)`` of each, every block the same size.  As in
`parallel.ops`, each rank calls a function with its block and gets its block
back.

  * **multiply** all-gathers the second operand's chunk axis over ``"c"``
    only (batch blocks never move), then runs the batched multiply (K1/K10/
    K11/K6 with the element from the grid) on ``[Bl, W, Cl] x [Bl, W, t2]``;
    the i-major output keeps the input layout despite the growth;
  * **decrypt** counts matches per local element (batched K3) and crosses
    ``"c"`` with a ``[Bl]`` int64 all-reduce; the bits stay batch-sharded;
  * **permute** is embarrassingly parallel in both axes (bit routing is per
    chunk): K8 with a batch grid, no collective.
"""

from __future__ import annotations

import torch

from csgn_tpu_torch.ops import dispatch
from csgn_tpu_torch.parallel.mesh import BATCH_AXIS, CHUNK_AXIS, Mesh, make_mesh
from csgn_tpu_torch.parallel.ops import _check_block, gather_chunks, reduce_counts
from csgn_tpu_torch.utils.metrics import op_metrics

__all__ = [
    "batch_chunk_mesh",
    "shard_batch",
    "sharded_mul_batch",
    "sharded_decrypt_batch",
    "sharded_permute_batch",
]


def batch_chunk_mesh(b_devices: int, c_devices: int, devices=None) -> Mesh:
    """A (b_devices, c_devices) mesh with axes ("b", "c") over the ranks
    `devices` (default: the first b_devices * c_devices ranks)."""
    return make_mesh((b_devices, c_devices), (BATCH_AXIS, CHUNK_AXIS), devices)


def _check_div(name: str, size: int, nd: int) -> None:
    if size % nd:
        raise ValueError(f"{name} {size} not divisible by mesh axis size {nd}")


def shard_batch(wt: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a whole ``[B, W, C]`` payload laid out as
    ``P("b", None, "c")``, on the mesh's device.  B and C must divide the
    axis sizes."""
    bd, cd = mesh.shape[BATCH_AXIS], mesh.shape[CHUNK_AXIS]
    _check_div("batch", wt.shape[0], bd)
    _check_div("chunks", wt.shape[-1], cd)
    bl, cl = wt.shape[0] // bd, wt.shape[-1] // cd
    i, j = mesh.coord(BATCH_AXIS), mesh.coord(CHUNK_AXIS)
    return wt[i * bl:(i + 1) * bl, :, j * cl:(j + 1) * cl].to(mesh.device).contiguous()


def sharded_mul_batch(a: torch.Tensor, b: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Batched chunk-sharded multiply: blocks ``[Bl, W, t1/cd] x [Bl, W,
    t2/cd] -> [Bl, W, t1*t2/cd]``, element i of the output the canonical
    cross product of the operands' elements i (bit-identical to the same
    block of the one-device batched product)."""
    _check_block("sharded_mul_batch", a, mesh)
    _check_block("sharded_mul_batch", b, mesh)
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(f"sharded_mul_batch: blocks must be [B, W, C] with one B, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    cd = mesh.shape[CHUNK_AXIS]
    t1, t2 = cd * a.shape[-1], cd * b.shape[-1]
    with op_metrics().record(
        "sharded.mul_batch", chunks_in=a.shape[0] * (t1 + t2), chunks_out=a.shape[0] * t1 * t2,
        bytes_moved=a.shape[0] * (t1 + t2 + t1 * t2) * a.shape[-2] * 4,
    ):
        return dispatch.mul_chunks_batched(a, gather_chunks(b, mesh, CHUNK_AXIS))


def sharded_decrypt_batch(words: torch.Tensor, mask: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Batched chunk-sharded decrypt: this rank's block ``[Bl, W, Cl]`` ->
    the bits ``int32[Bl]`` of its elements, the same on every rank of its
    ``"c"`` line.  One ``[Bl]`` int64 all-reduce over ``"c"``."""
    _check_block("sharded_decrypt_batch", words, mesh)
    if words.dim() != 3:
        raise ValueError(f"sharded_decrypt_batch: block must be [B, W, C], got "
                         f"{tuple(words.shape)}")
    with op_metrics().record("sharded.decrypt_batch",
                             chunks_in=words.shape[0] * words.shape[-1],
                             bytes_moved=words.numel() * 4):
        counts = reduce_counts(dispatch.decrypt_count(words, mask), mesh, CHUNK_AXIS)
        return (counts & 1).to(torch.int32)


def sharded_permute_batch(words: torch.Tensor, plan, mesh: Mesh) -> torch.Tensor:
    """Batched chunk-sharded permutation (one plan, every element): K8 on
    this rank's block, no collective; the output keeps the layout."""
    _check_block("sharded_permute_batch", words, mesh)
    mesh.coord(CHUNK_AXIS)
    with op_metrics().record("sharded.permute_batch",
                             chunks_in=words.shape[0] * words.shape[-1],
                             chunks_out=words.shape[0] * words.shape[-1],
                             bytes_moved=2 * words.numel() * 4):
        return dispatch.permute_batched(words, plan)
