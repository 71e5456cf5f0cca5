"""Build and load the port's CUDA kernels (`csgn_tpu_torch/csrc/*.cu`).

The sources are compiled by ``nvcc`` for ``sm_90a``, one process per source,
all started together, and linked into one shared library with a plain C
interface, ``build/csgn_tpu_torch/libcsgn_kernels.so`` under the checkout,
loaded with ctypes.  The build runs at first use and again whenever the
sources' content hash changes; a missing ``nvcc`` or a failed build raises —
there is no fallback.  ``ptxas -v``'s report of every kernel (registers,
spill bytes) is kept beside the library as ``ptxas.log`` and parsed by
`kernel_resources`.

Calling convention of every C entry: pointers and the stream are
``ctypes.c_void_p``, sizes ``ctypes.c_int64``; it returns
``cudaGetLastError()`` (0 = success), and `check` raises on anything else.

``LAUNCHES`` counts, per wrapper, the kernels actually launched (not the
calls served by the plain torch versions on CPU tensors).  A batched entry
takes the element from ``blockIdx.y`` and launches one grid per
``MAX_GRID_Y`` elements (`grids`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile

import torch

__all__ = ["LAUNCHES", "NVCC_FLAGS", "MAX_GRID_Y", "lib", "library_path", "kernel_resources",
           "check", "stream_of", "ptr", "grids"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "csgn_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

MAX_GRID_Y = 65535  # CUDA's limit on gridDim.y

LAUNCHES = {
    "mul_chunks": 0,
    "mul_decrypt": 0,
    "decrypt_parity": 0,
    "chunk_matches": 0,
    "encrypt_bits_counter": 0,
    "encrypt_bits_philox": 0,
    "encrypt_bits_threefry": 0,
    # K7's launches by path (csrc/encrypt.cu), also counted under
    # "encrypt_bits_philox": the tile path (W <= PHILOX_TILE_MAX_WORDS), of
    # which those with 4-byte row stores (batch % 4 != 0), and the column path
    "philox_tile": 0,
    "philox_tile_4byte": 0,
    "philox_column": 0,
    "philox_streams": 0,
    "fill_anchor": 0,
    # the same K1-K3 kernels launched on batched [B, W, C] operands
    "mul_chunks_batched": 0,
    "mul_decrypt_batched": 0,
    "decrypt_parity_batched": 0,
    "chunk_matches_batched": 0,
    # the multiply's unaligned and b-streamed modes (csrc/mul.cu)
    "mul_chunks_unaligned": 0,
    "mul_decrypt_unaligned": 0,
    "mul_chunks_tiled": 0,
    "mul_decrypt_tiled": 0,
    "mul_chunks_unaligned_batched": 0,
    "mul_decrypt_unaligned_batched": 0,
    "mul_chunks_tiled_batched": 0,
    "mul_decrypt_tiled_batched": 0,
    # the column-match pass that writes mul_decrypt's count (csrc/mul.cu),
    # launched beside the product of every fused call, in every mode
    "mul_count": 0,
    "mul_count_batched": 0,
    "apply_benes": 0,
    "apply_benes_batch": 0,
    "apply_benes_decrypt": 0,
    # launches of the three Beneš wrappers on the lane-group path (64 < WP <=
    # 2048) and on the wide path (WP > 2048), also counted under the
    # wrapper's own key
    "benes_lanes": 0,
    "benes_wide": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    # a, b, mask, out, count, scratch, batch, w, t1, t2, mode, stream
    "csgn_mul": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # words, mask, out, batch, w, c, per_chunk, vec, stream
    "csgn_decrypt": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, masks, sched, key, out, count, scratch, batch, w, c, wp, stages, w_net,
    # plan_stride, path, stream
    "csgn_benes": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # bits, key_idx, mask, valid, out, w, d, batch, col0, seed_lo, seed_hi, stream
    "csgn_encrypt_counter": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # ..., seed_hi, path (0 column, 1 tile with 16-byte stores, 2 tile with
    # 4-byte stores), stream
    "csgn_encrypt_philox": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # bits, key_idx, mask, valid, out, w, d, batch, col0, total, then the
    # words of k_words, k_rbit and randint's two keys, stream
    "csgn_encrypt_threefry": (_P, _P, _P, _P, _P, *(_I,) * 13, _P),
    # out, rows, batch, seed_lo, seed_hi, stream
    "csgn_philox_streams": (_P, _I, _I, _I, _I, _P),
    # out, value, w, c, stream
    "csgn_fill_anchor": (_P, _I, _I, _I, _P),
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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
        jobs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = str(pathlib.Path(tmp) / f"{src.stem}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed, reports = [], []
        for cmd, _, proc in jobs:  # wait for every compile, then report
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
            reports.append(out + err)
        if failed:
            raise RuntimeError("\n".join(failed))
        out_so = str(pathlib.Path(tmp) / so.name)
        cmd = [nvcc, "-shared", *(obj for _, obj, _ in jobs), "-o", out_so]
        res = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}\n{res.stderr}"
            )
        os.replace(out_so, so)  # atomic: a concurrent loader sees old or new
    so.with_name("ptxas.log").write_text("".join(reports))
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


def kernel_resources() -> list[dict]:
    """Every kernel of the built library as ``ptxas -v`` reported it, by its
    mangled name: ``{"kernel", "registers", "spill_stores", "spill_loads"}``
    (bytes)."""
    lib()
    text = library_path().with_name("ptxas.log").read_text()
    rows, cur = [], None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            cur = {"kernel": m.group(1), "registers": None, "spill_stores": None,
                   "spill_loads": None}
            rows.append(cur)
        elif cur is not None and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
            cur["registers"] = int(m.group(1))
    return rows


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


def grids(batch: int) -> int:
    """Kernel launches a batched C entry makes for `batch` elements."""
    return -(-batch // MAX_GRID_Y)
