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

This module writes one block per ciphertext (one process holds the whole
payload) and loads any block table, such as the 8-block directories that
the JAX package writes from a chunk-sharded mesh.  The JAX package's
per-process writes and its resharding load onto a mesh (``mesh=``) wait for
the port's multi-device layer.  Loads put the objects on `device`: None is
the current CUDA device, ``"cpu"`` the CPU.
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


def save_state_sharded(dirpath, objects: dict) -> None:
    """Checkpoint {name: Ciphertext|SecretKey|Permutation} as a directory:
    each ciphertext's payload as one block file, the rest in ``aux.npz``,
    and the manifest (the JAX package's `save_state_sharded` format)."""
    p = pathlib.Path(dirpath)
    p.mkdir(parents=True, exist_ok=True)
    manifest: dict = {"version": FORMAT_VERSION, "entries": {}}
    aux: dict = {}
    for name, obj in objects.items():
        _check_name(name)
        if not isinstance(obj, Ciphertext):
            aux[name] = obj
            continue
        fname = f"{name}.c0.npy"
        np.save(p / fname, np.ascontiguousarray(obj.chunk_major()))
        manifest["entries"][name] = {
            "n": obj.ctx.n, "d": obj.ctx.d, "chunks": obj.chunks,
            "blocks": [[0, obj.chunks, fname]],
        }
    if aux:
        save_state(p / "aux.npz", aux)
    (p / MANIFEST).write_text(json.dumps(manifest))


def _read_blocks(path: pathlib.Path, name: str, blocks, w: int, chunks: int) -> np.ndarray:
    """Word-major uint32 ``[W, chunks]`` assembled from every block in column
    order.  Nothing is padded: the blocks must tile ``[0, chunks)``."""
    parts, end = [], 0
    for start, cnt, fname in sorted(blocks):
        blk = np.load(path / fname, mmap_mode="r")
        if blk.ndim != 2 or blk.shape != (cnt, w):
            raise ValueError(f"{name!r}: block {fname} has shape {blk.shape}, not [{cnt}, W={w}]")
        if start != end:
            break
        parts.append(np.ascontiguousarray(blk.T))
        end += cnt
    if end != chunks:
        raise ValueError(f"{name!r}: blocks do not cover [0, {chunks})")
    return np.concatenate(parts, axis=1) if parts else np.zeros((w, 0), np.uint32)


def load_state_sharded(dirpath, device=None) -> dict:
    """Load a sharded checkpoint written by either package; every
    ciphertext's payload is assembled from its blocks, whatever their number
    and sizes, at its exact saved chunk count."""
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
        words = _read_blocks(p, name, blocks, ctx.words32, int(ent["chunks"]))
        out[name] = Ciphertext(words_from_numpy(words, device), ctx)
    return out
