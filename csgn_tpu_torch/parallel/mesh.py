"""Meshes of `torch.distributed` ranks with named axes.

Counterpart of `csgn_tpu.parallel.mesh`.  Axis conventions:
  * ``"c"`` — the chunk axis of a ciphertext (the superlinear growth axis);
  * ``"b"`` — the batch axis over independent ciphertexts (data parallel).

A JAX mesh is a grid of devices that one program drives; here every rank is
its own process, and a `Mesh` is the grid of ranks plus, for this rank, its
coordinate on each axis and the process group of its line along each axis
(the ranks that differ from it on that axis only).  Collectives along an
axis run in that group.  Every rank of the job builds every mesh, in the
same order (process groups are created collectively), including ranks that
are not in it (a mesh may cover the first ranks only, as a resumed job on
fewer devices does).

The backend follows the device: the groups inherit the default group's
backend, NCCL for CUDA tensors (this rank's blocks live on its current CUDA
device) and gloo for CPU tensors (`multihost.initialize`).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "chunk_mesh", "CHUNK_AXIS", "BATCH_AXIS"]

CHUNK_AXIS = "c"
BATCH_AXIS = "b"


def _group_device() -> torch.device:
    """Where this rank's blocks live, from the default group's backend."""
    backend = dist.get_backend()
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if backend == "gloo":
        return torch.device("cpu")
    raise RuntimeError(f"csgn_tpu_torch.parallel runs on nccl (cuda) or gloo (cpu), "
                       f"not {backend!r}")


class Mesh:
    """A grid of ranks with named axes, seen from this rank.

    ``shape`` maps each axis name to its size (as a JAX mesh's does),
    ``ranks`` is the grid of global ranks, and ``device`` is where this
    rank's blocks live.  For a rank in the mesh, ``coord(axis)`` is its
    position along an axis and ``group(axis)`` the process group of its line
    along it; ``group_all`` spans every rank of the mesh.
    """

    def __init__(self, ranks: np.ndarray, axis_names: tuple[str, ...]):
        if not dist.is_initialized():
            raise RuntimeError("no process group: call csgn_tpu_torch.parallel.initialize first")
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh of shape {ranks.shape} needs {ranks.ndim} distinct axis "
                             f"names, got {axis_names}")
        world = dist.get_world_size()
        flat = ranks.reshape(-1).tolist()
        if len(set(flat)) != len(flat) or min(flat) < 0 or max(flat) >= world:
            raise ValueError(f"mesh ranks must be distinct ranks of the world of {world}")
        self.ranks = ranks
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self.device = _group_device()
        me = dist.get_rank()
        where = np.argwhere(ranks == me)
        self._coords = dict(zip(self.axis_names, (int(i) for i in where[0]))) if len(where) \
            else None
        # Every rank creates every group, in one order (a collective call).
        self._groups = {}
        for ax, name in enumerate(self.axis_names):
            others = [range(n) for i, n in enumerate(ranks.shape) if i != ax]
            for idx in itertools.product(*others):
                sl = list(idx)
                sl.insert(ax, slice(None))
                line = ranks[tuple(sl)].tolist()
                group = dist.new_group(ranks=line)
                if me in line:
                    self._groups[name] = group
        if ranks.ndim == 1:  # the one line is the whole mesh
            self.group_all = self._groups.get(self.axis_names[0])
        else:
            group_all = dist.new_group(ranks=sorted(flat))
            self.group_all = group_all if me in flat else None

    @property
    def contains(self) -> bool:
        """Whether this rank is in the mesh."""
        return self._coords is not None

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def _check_member(self) -> None:
        if self._coords is None:
            raise ValueError(f"rank {dist.get_rank()} is not in this mesh of ranks "
                             f"{self.ranks.reshape(-1).tolist()}")

    def coord(self, axis: str) -> int:
        """This rank's position along `axis`."""
        self._check_member()
        return self._coords[axis]

    def group(self, axis: str):
        """The process group of this rank's line along `axis`."""
        self._check_member()
        return self._groups[axis]

    def peer(self, axis: str, position: int) -> int:
        """The global rank at `position` on this rank's line along `axis`."""
        self._check_member()
        idx = [self._coords[a] for a in self.axis_names]
        idx[self.axis_names.index(axis)] = position % self.shape[axis]
        return int(self.ranks[tuple(idx)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.ranks.reshape(-1).tolist()}, device={self.device})"


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...], devices=None) -> Mesh:
    """A mesh of `shape` over the ranks `devices` (default: the first
    prod(shape) ranks of the job), laid out in row-major order."""
    count = int(np.prod(shape))
    ranks = np.arange(count) if devices is None else np.asarray(devices)
    if ranks.size != count:
        raise ValueError(f"mesh shape {shape} needs {count} ranks, got {ranks.size}")
    return Mesh(ranks.reshape(shape), tuple(axis_names))


def chunk_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the chunk axis of the first `n_devices` ranks (default:
    every rank of the job)."""
    n = n_devices if n_devices is not None else dist.get_world_size()
    return make_mesh((n,), (CHUNK_AXIS,))
