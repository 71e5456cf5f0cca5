"""Serialization and checkpoint/resume, in the JAX package's format.

Counterpart of `csgn_tpu.io`, with the same on-disk layout, so a file or a
checkpoint directory written by either package loads in the other,
bit-equal:

  * payload: chunk-major uint32 words (``[chunks, W]``), the host and
    serialization order;
  * metadata: ``meta = [FORMAT_VERSION, n, d]`` (int64), a ``kind`` string;
  * container: ``.npz`` (a zip of ``.npy`` arrays).

`save_state`/`load_state` bundle named ciphertexts, keys and permutations
into one file.  The sharded checkpoint is a directory:

  manifest.json          {"version", "entries": {name: {n, d, chunks,
                         blocks: [[start, count, file], ...]}}}
  <name>.c<start>.npy    chunk-major uint32[count, W] payload block
  aux.npz                the keys and permutations, via `save_state`

Without a mesh, one process writes one block per ciphertext.  With a mesh
of ranks (`csgn_tpu_torch.parallel`), every rank calls
`save_state_sharded` with its own chunk blocks and writes them, and rank 0
writes the manifest with the global block table; no rank holds a whole
payload.  Loads read any block table, such as the 8-block directories that
the JAX package writes from a chunk-sharded mesh, and with ``mesh=`` each
rank reads only the column range of its block (memory-mapped), zero-padded
up to the new axis size, so a job resumes on any number of ranks.  Loads put
the objects on `device` (None is the current CUDA device, ``"cpu"`` the CPU)
or, with a mesh, on the mesh's device.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from csgn_tpu_torch._device import resolve_device
from csgn_tpu_torch.ciphertext import Ciphertext
from csgn_tpu_torch.context import Context
from csgn_tpu_torch.layout import words_from_numpy
from csgn_tpu_torch.permutation import Permutation
from csgn_tpu_torch.secret_key import SecretKey

__all__ = [
    "FORMAT_VERSION",
    "save_ciphertext",
    "load_ciphertext",
    "save_secret_key",
    "load_secret_key",
    "save_permutation",
    "load_permutation",
    "save_state",
    "load_state",
    "save_state_sharded",
    "load_state_sharded",
]

FORMAT_VERSION = 1
MANIFEST = "manifest.json"


def _meta(ctx: Context) -> np.ndarray:
    return np.array([FORMAT_VERSION, ctx.n, ctx.d], dtype=np.int64)


def _ctx_from_meta(meta: np.ndarray) -> Context:
    version, n, d = (int(x) for x in meta[:3])
    if version != FORMAT_VERSION:
        raise ValueError(f"unsupported csgn checkpoint version {version}")
    return Context(n, d)


def _check_perm_entry(z, prefix: str) -> None:
    """Validate a stored permutation's version and length (files without a
    meta entry are version 1, as the JAX package reads them)."""
    if f"{prefix}meta" in z.files:
        meta = z[f"{prefix}meta"]
        version, n = int(meta[0]), int(meta[1])
        if version != FORMAT_VERSION:
            raise ValueError(f"unsupported csgn permutation version {version}")
        if n != len(z[f"{prefix}perm"]):
            raise ValueError(
                f"permutation length {len(z[f'{prefix}perm'])} != recorded n {n}"
            )


# -- single objects ---------------------------------------------------------


def save_ciphertext(path, ct: Ciphertext) -> None:
    np.savez(path, kind=np.array("ciphertext"), meta=_meta(ct.ctx), words=ct.chunk_major())


def load_ciphertext(path, device=None) -> Ciphertext:
    device = resolve_device(device)
    with np.load(path) as z:
        return Ciphertext.from_chunk_major(z["words"], _ctx_from_meta(z["meta"]), device)


def save_secret_key(path, sk: SecretKey) -> None:
    np.savez(path, kind=np.array("secret_key"), meta=_meta(sk.ctx), indices=sk.indices)


def load_secret_key(path, device=None) -> SecretKey:
    device = resolve_device(device)
    with np.load(path) as z:
        return SecretKey(_ctx_from_meta(z["meta"]), z["indices"], device)


def _perm_meta(p: Permutation) -> np.ndarray:
    return np.array([FORMAT_VERSION, p.n], dtype=np.int64)


def save_permutation(path, p: Permutation) -> None:
    np.savez(path, kind=np.array("permutation"), meta=_perm_meta(p), perm=p.perm)


def load_permutation(path) -> Permutation:
    """A permutation is host numpy: it has no device."""
    with np.load(path) as z:
        _check_perm_entry(z, "")
        return Permutation(z["perm"])


# -- whole-computation checkpoints ------------------------------------------

_SAVERS = {
    Ciphertext: ("ciphertext", lambda o: {"words": o.chunk_major(), "meta": _meta(o.ctx)}),
    SecretKey: ("secret_key", lambda o: {"indices": o.indices, "meta": _meta(o.ctx)}),
    Permutation: ("permutation", lambda o: {"perm": o.perm, "meta": _perm_meta(o)}),
}


def _check_name(name: str) -> None:
    if "/" in name:
        raise ValueError(f"state name may not contain '/': {name!r}")


def save_state(path, objects: dict) -> None:
    """Checkpoint a dict of {name: Ciphertext|SecretKey|Permutation}."""
    arrays: dict[str, np.ndarray] = {}
    for name, obj in objects.items():
        _check_name(name)
        for klass, (kind, fn) in _SAVERS.items():
            if isinstance(obj, klass):
                arrays[f"{name}/kind"] = np.array(kind)
                for field, arr in fn(obj).items():
                    arrays[f"{name}/{field}"] = arr
                break
        else:
            raise TypeError(f"cannot checkpoint object of type {type(obj)}")
    np.savez(path, **arrays)


def load_state(path, device=None) -> dict:
    """Load a checkpoint written by `save_state` (either package's)."""
    device = resolve_device(device)
    out: dict = {}
    with np.load(path) as z:
        names = sorted({k.split("/", 1)[0] for k in z.files})
        for name in names:
            kind = str(z[f"{name}/kind"])
            if kind == "ciphertext":
                ctx = _ctx_from_meta(z[f"{name}/meta"])
                out[name] = Ciphertext.from_chunk_major(z[f"{name}/words"], ctx, device)
            elif kind == "secret_key":
                ctx = _ctx_from_meta(z[f"{name}/meta"])
                out[name] = SecretKey(ctx, z[f"{name}/indices"], device)
            elif kind == "permutation":
                _check_perm_entry(z, f"{name}/")
                out[name] = Permutation(z[f"{name}/perm"])
            else:
                raise ValueError(f"unknown kind {kind!r} for {name!r}")
    return out


# -- sharded checkpoints ------------------------------------------------------


def _block_entries(objects: dict, mesh, axis: str) -> tuple[dict, dict]:
    """This rank's ``{name: [start, count, file, n, d]}`` (chunk-axis blocks,
    written by the rank whose other coordinates are all 0) and the rest."""
    blocks, aux = {}, {}
    for name, obj in objects.items():
        _check_name(name)
        if not isinstance(obj, Ciphertext):
            aux[name] = obj
            continue
        c = obj.chunks
        start = 0 if mesh is None else mesh.coord(axis) * c
        blocks[name] = [start, c, f"{name}.c{start}.npy", obj.ctx.n, obj.ctx.d]
    return blocks, aux


def save_state_sharded(dirpath, objects: dict, mesh=None, axis: str = "c") -> None:
    """Checkpoint {name: Ciphertext|SecretKey|Permutation} as a directory: the
    ciphertext payloads as block files, the rest in ``aux.npz``, and the
    manifest (the JAX package's `save_state_sharded` format).

    Without `mesh`, one process writes each ciphertext as one block.  With a
    mesh, call it from every rank of the mesh (a collective), each with its
    own blocks of the chunk-sharded ciphertexts (equal sizes, as
    `parallel.shard_ciphertext` cuts them); keys and permutations are the
    same on every rank.  Each rank writes its blocks (ranks off coordinate
    0 of the other axes hold replicas and write none), rank 0 of the mesh
    writes the aux file and the manifest with the block table gathered from
    every rank (`all_gather_object`), and all ranks return after the
    manifest is written.
    """
    import torch.distributed as dist

    p = pathlib.Path(dirpath)
    p.mkdir(parents=True, exist_ok=True)
    blocks, aux = _block_entries(objects, mesh, axis)
    writer = mesh is None or all(mesh.coord(a) == 0 for a in mesh.axis_names if a != axis)
    if writer:
        for name, (_, _, fname, _, _) in blocks.items():
            np.save(p / fname, np.ascontiguousarray(objects[name].chunk_major()))
    tables = [blocks]
    if mesh is not None:
        tables = [None] * mesh.size
        dist.all_gather_object(tables, blocks, group=mesh.group_all)
    if mesh is None or dist.get_rank() == int(mesh.ranks.reshape(-1)[0]):
        manifest: dict = {"version": FORMAT_VERSION, "entries": {}}
        for name in blocks:
            table = sorted({tuple(t[name][:3]) for t in tables})
            n, d = blocks[name][3:]
            if any(t[name][3:] != [n, d] for t in tables):
                raise ValueError(f"{name!r}: ranks disagree on the context")
            manifest["entries"][name] = {
                "n": n, "d": d, "chunks": sum(cnt for _, cnt, _ in table),
                "blocks": [list(b) for b in table],
            }
        if aux:
            save_state(p / "aux.npz", aux)
        (p / MANIFEST).write_text(json.dumps(manifest))
    if mesh is not None:
        dist.barrier(group=mesh.group_all)


def _read_cols(path: pathlib.Path, name: str, blocks, w: int, chunks: int, col0: int,
               col1: int) -> np.ndarray:
    """Word-major uint32 ``[W, col1 - col0]`` from the blocks, which must tile
    ``[0, chunks)`` in column order; only the needed rows of each
    memory-mapped block file are read, and columns at or past `chunks` are
    zero pad (a resume onto a mesh that does not divide the chunk count)."""
    parts, end = [], 0
    for start, cnt, fname in sorted(blocks):
        if start != end:
            break
        end += cnt
        lo, hi = max(col0, start), min(col1, start + cnt)
        if lo >= hi:
            continue
        blk = np.load(path / fname, mmap_mode="r")
        if blk.ndim != 2 or blk.shape != (cnt, w):
            raise ValueError(f"{name!r}: block {fname} has shape {blk.shape}, not [{cnt}, W={w}]")
        parts.append(np.ascontiguousarray(blk[lo - start:hi - start].T))
    if end != chunks:
        raise ValueError(f"{name!r}: blocks do not cover [0, {chunks})")
    if col1 > chunks:
        parts.append(np.zeros((w, col1 - max(col0, chunks)), np.uint32))
    return np.concatenate(parts, axis=1) if parts else np.zeros((w, 0), np.uint32)


def load_state_sharded(dirpath, mesh=None, axis: str = "c", device=None) -> dict:
    """Load a sharded checkpoint written by either package.

    Without `mesh`, every ciphertext's payload is assembled from its blocks,
    whatever their number and sizes, at its exact saved chunk count, on
    `device`.  With a mesh (call it from the ranks of the mesh), each rank
    gets its own block: the chunk count is zero-padded up to a multiple of
    the axis size (pad chunks are canonical and parity-neutral, as
    `parallel.shard_ciphertext` pads), and the rank reads only the column
    range of its block, on the mesh's device.  The mesh need not have the
    shape the checkpoint was written on.
    """
    if mesh is not None:
        if device is not None:
            raise ValueError("load_state_sharded: a mesh load puts the blocks on the mesh's "
                             "device; pass mesh or device, not both")
        device = mesh.device
    device = resolve_device(device)
    p = pathlib.Path(dirpath)
    manifest = json.loads((p / MANIFEST).read_text())
    if manifest["version"] != FORMAT_VERSION:
        raise ValueError(f"unsupported csgn checkpoint version {manifest['version']}")
    out: dict = {}
    if (p / "aux.npz").exists():
        out.update(load_state(p / "aux.npz", device))
    for name, ent in manifest["entries"].items():
        ctx = Context(int(ent["n"]), int(ent["d"]))
        blocks = [(int(s), int(c), f) for s, c, f in ent["blocks"]]
        c = int(ent["chunks"])
        col0, col1 = 0, c
        if mesh is not None:
            nd = mesh.shape[axis]
            blk = -(-c // nd)
            col0 = mesh.coord(axis) * blk
            col1 = col0 + blk
        words = _read_cols(p, name, blocks, ctx.words32, c, col0, col1)
        out[name] = Ciphertext(words_from_numpy(words, device), ctx)
    return out
