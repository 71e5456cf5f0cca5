"""Multi-process entry points: the process group, the global mesh, and
sharding a whole ciphertext into this rank's block.

Counterpart of `csgn_tpu.parallel.multihost`.  One code path serves one
card, one host and many hosts: every rank runs the same program on its own
block (`parallel.ops`), and the collectives cross ranks through
`torch.distributed` — NCCL between CUDA devices, gloo between CPU processes
(the tests run several CPU processes, as the JAX package's tests run several
JAX processes).

The checkpoint is the recovery unit: `csgn_tpu_torch.io.save_state_sharded`
writes each rank's block, and `load_state_sharded(dir, mesh=...)` reads back
only this rank's column range of a mesh of any size, so a job may resume on
a different number of ranks.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from csgn_tpu_torch._device import resolve_device
from csgn_tpu_torch.ciphertext import Ciphertext
from csgn_tpu_torch.parallel.mesh import CHUNK_AXIS, Mesh, chunk_mesh

__all__ = ["initialize", "global_chunk_mesh", "shard_ciphertext", "pad_chunks_to"]


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, device=None) -> torch.device:
    """Join the job's process group (`torch.distributed.init_process_group`)
    and return this rank's device.

    With no arguments the rendezvous, world size and rank come from the
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``:
    ``env://``).  `coordinator_address` is ``host:port`` (tcp) or any init
    URL (``tcp://...``, ``file://...``).  The backend follows `device`:
    None is the CUDA device ``LOCAL_RANK`` (else rank mod the device count),
    over NCCL, and raises where there is no card or no NCCL; ``"cpu"`` runs
    over gloo.  Nothing falls back from one to the other.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("csgn_tpu_torch.parallel: torch has no NCCL for CUDA ranks")
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"csgn_tpu_torch.parallel runs on cuda or cpu, not {dev}")
    init_method = "env://"
    if coordinator_address is not None:
        init_method = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
    rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    world = num_processes if num_processes is not None \
        else int(os.environ.get("WORLD_SIZE", "1"))
    if dev.type == "cuda":
        if device is None:
            local = os.environ.get("LOCAL_RANK")
            index = int(local) if local is not None else rank % torch.cuda.device_count()
            dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return dev


def global_chunk_mesh() -> Mesh:
    """1-D mesh over every rank of the job."""
    return chunk_mesh(dist.get_world_size())


def pad_chunks_to(ct: Ciphertext, multiple: int) -> tuple[Ciphertext, int]:
    """Zero-pad the chunk axis to a multiple (zero chunks are decrypt-neutral:
    they never match a nonzero mask).  Returns (padded, original_chunks)."""
    ct = ct.canonical()  # sharding pads are untracked: resolve any order tag
    c = ct.chunks
    cp = -(-c // multiple) * multiple
    if cp == c:
        return ct, c
    return Ciphertext(torch.nn.functional.pad(ct.wt, (0, cp - c)), ct.ctx), c


def shard_ciphertext(ct: Ciphertext, mesh: Mesh, axis: str = CHUNK_AXIS) -> Ciphertext:
    """This rank's block of a whole ciphertext, chunk-sharded over `axis`.

    The chunk axis is zero-padded to a multiple of the axis size first, then
    cut into equal contiguous blocks in rank order; the block lands on the
    mesh's device.  Use it to lay a loaded or replicated ciphertext onto the
    current (possibly different-sized) mesh.
    """
    nd = mesh.shape[axis]
    padded, _ = pad_chunks_to(ct, nd)
    blk = padded.chunks // nd
    i = mesh.coord(axis)
    return Ciphertext(padded.wt[:, i * blk:(i + 1) * blk].to(mesh.device), ct.ctx)
