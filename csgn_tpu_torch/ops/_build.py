"""Build and load the port's CUDA kernels (`csgn_tpu_torch/csrc/*.cu`).

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, ``build/csgn_tpu_torch/libcsgn_kernels.so`` under the
checkout, and loaded with ctypes.  The build runs at first use and again
whenever the sources' content hash changes; a missing ``nvcc`` or a failed
build raises — there is no fallback.

Calling convention of every C entry: pointers and the stream are
``ctypes.c_void_p``, sizes ``ctypes.c_int64``; it returns
``cudaGetLastError()`` (0 = success), and `check` raises on anything else.

``LAUNCHES`` counts, per wrapper, the kernels actually launched (not the
calls served by the plain torch versions on CPU tensors).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

__all__ = ["LAUNCHES", "NVCC_FLAGS", "lib", "library_path", "check", "stream_of", "ptr"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "csgn_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES = {
    "mul_chunks": 0,
    "mul_decrypt": 0,
    "decrypt_parity": 0,
    "chunk_matches": 0,
    "encrypt_bits_counter": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    # a, b, mask, out, count, w, t1, t2, vec, stream
    "csgn_mul": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # words, mask, out, w, c, per_chunk, vec, stream
    "csgn_decrypt": (_P, _P, _P, _I, _I, _I, _I, _P),
    # bits, key_idx, mask, valid, out, w, d, batch, seed_lo, seed_hi, stream
    "csgn_encrypt_counter": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}


def _sources() -> list[pathlib.Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of csgn_tpu_torch need the CUDA toolkit to build"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def library_path() -> pathlib.Path:
    return _BUILD / "libcsgn_kernels.so"


def _build(so: pathlib.Path, stamp: pathlib.Path, digest: str) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
        res = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}\n{res.stderr}"
            )
        os.replace(tmp, so)  # atomic: a concurrent loader sees old or new
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    stamp.write_text(digest)


@functools.cache
def lib() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library, once per
    process."""
    so = library_path()
    stamp = so.with_suffix(".sha256")
    digest = _digest()
    if not (so.is_file() and stamp.is_file() and stamp.read_text() == digest):
        _build(so, stamp, digest)
    handle = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.csgn_error_string.argtypes = (ctypes.c_int,)
    handle.csgn_error_string.restype = ctypes.c_char_p
    return handle


def check(name: str, err: int) -> None:
    """Raise if a C entry reported a CUDA error (the launch did not happen)."""
    if err != 0:
        text = lib().csgn_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({text}) at launch")


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on `t`'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()
