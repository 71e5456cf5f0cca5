"""Where the Philox encrypt K7's time goes, from variants timed in turns.

    python3 -m csgn_tpu_torch.tools.k7_split [--sass FILE]

builds `k7_split.cu` (variants of K7, timing only) beside the port's
library and times, at Context(1247, 16) over 2^22 columns, each ms per call
of a run of five launches over distinct seeds after one untimed call (CUDA
events), in turns (the list forward, backward, forward, backward):

  * ``column``: the column path, forced (one thread a column storing to
    global memory, the fix-up's broken word last);
  * ``a``: the column path with no deferred 4-byte scatter (wrong words);
  * ``b``: ``a`` with a branch-free fix-up, one store a row (wrong words);
  * ``tile``, ``tile_4byte``: the tile path with 16-byte and with 4-byte
    row stores (forced); ``tile256``, ``tile64``: the tile path at 256 and
    at 64 columns a block; ``f``, ``f_plain``: the tile path on a persistent
    grid, with streaming and with plain 16-byte stores; ``g``: warp-owned
    tiles, the rows the fix-up never touches written as they are generated;
  * ``d``: the tile path's generator and fix-up with no stores;
  * ``e``: the tile path's stores with no generator.

The tile forms are first checked bit-equal to the column path and to the
plain version.  Then, at W in {40, 64, 128, 192, 256} (n = 32 W - 1,
d = 16), the column path in turns with the tile path at 128 columns a
block, on the persistent grid, in warp-owned tiles and, where its tile fits,
at 256.  With ``--sass FILE`` it writes the SASS of the library's Philox
kernels to FILE and prints each kernel's opcode counts.  Prints one JSON
line; the card's name and power limit are in it.  Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import pathlib
import re
import statistics
import subprocess

import numpy as np
import torch

from csgn_tpu_torch import Context, SecretKey
from csgn_tpu_torch.layout import bit_positions_to_mask, words_from_numpy
from csgn_tpu_torch.ops import _build, encrypt_kernels as ek
from csgn_tpu_torch.tools.ab_times import run_ms

HBM_BYTES_PER_S = 3.35e12
BATCH = 1 << 22
SWEEP_WS = (40, 64, 128, 192, 256)
MAX_SMEM = 232448   # dynamic shared memory a block may use on the H100
_VARIANTS = {"a": 0, "b": 1, "tile128": 2, "tile256": 3, "d": 4, "e": 5, "f": 6, "tile64": 7, "f_plain": 8, "g": 9}
_P, _I = ctypes.c_void_p, ctypes.c_int64


def build_variants() -> ctypes.CDLL:
    """nvcc k7_split.cu (with the library's flags) into the build directory."""
    src = pathlib.Path(__file__).resolve().with_suffix(".cu")
    so = _build.library_path().with_name("libk7_split.so")
    so.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(src), "-o",
                          str(so)], capture_output=True, text=True, timeout=600, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{res.stdout}\n{res.stderr}")
    so.with_name("k7_split_ptxas.log").write_text(res.stdout + res.stderr)
    lib = ctypes.CDLL(str(so))
    lib.k7_split_variant.argtypes = (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
    lib.k7_split_variant.restype = ctypes.c_int
    return lib


def operands(w: int, d: int, dev):
    """Key operands at W = `w` (n = 32 w - 1), or Context(1247, 16)'s."""
    if w == 40:
        ctx = Context(1247, 16)
        return SecretKey(ctx, np.random.default_rng(0).choice(ctx.n, ctx.d, replace=False),
                         dev).encrypt_operands
    n = 32 * w - 1
    idx = np.random.default_rng(w).choice(n, d, replace=False).astype(np.int32)
    return (torch.from_numpy(idx).to(dev), words_from_numpy(bit_positions_to_mask(idx, n)[:w], dev),
            words_from_numpy(bit_positions_to_mask(np.arange(n), n)[:w], dev))


def variant_fn(lib, name: str, bits, ops):
    w = ops[1].shape[0]
    bits32 = bits.to(torch.int32).contiguous()

    def fn(seed: int) -> torch.Tensor:
        out = torch.empty((w, bits.shape[0]), dtype=torch.int32, device=bits.device)
        err = lib.k7_split_variant(_VARIANTS[name], bits32.data_ptr(), *(t.data_ptr()
                                   for t in ops), out.data_ptr(), w, ops[0].shape[0],
                                   bits.shape[0], 0, seed & 0xFFFFFFFF, seed >> 32,
                                   torch.cuda.current_stream().cuda_stream)
        _build.check(f"k7_split {name}", err)
        return out
    return fn


def in_turns(fns: dict, seeds: list, rounds: int = 2) -> dict:
    times = {name: [] for name in fns}
    order = list(fns)
    for _ in range(rounds):
        for name in order + order[::-1]:
            times[name].append(run_ms(fns[name], seeds))
    return {name: {"runs": t, "median": statistics.median(t)} for name, t in times.items()}


def sass_counts(out_file: pathlib.Path) -> dict:
    """The library's Philox kernels' SASS (cuobjdump) written to `out_file`;
    opcode counts per kernel."""
    cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    kept, counts = [], {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if not re.search(r"philox_tile_kernel|encrypt_kernelILb1E|philox_streams", name):
            continue
        kept.append("Function : " + part)
        ops = collections.Counter()
        for line in part.splitlines():
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m:
                ops[m.group(1)] += 1
        counts[name] = dict(ops.most_common())
    out_file.parent.mkdir(parents=True, exist_ok=True)
    out_file.write_text("".join(kept))
    return counts


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sass", type=pathlib.Path, help="write the Philox kernels' SASS here")
    args = parser.parse_args()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    _build.lib()
    lib = build_variants()
    bits = torch.randint(0, 2, (BATCH,), dtype=torch.int32, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    seeds = list(range(1, 6))
    ops = operands(40, 16, dev)

    def forced(path):
        return lambda s: ek._philox_cuda(s, bits, *ops, path=path)

    want = ek.encrypt_bits_philox_plain(7, bits, *ops)
    for name, fn in (("column", forced("column")), ("tile", forced("tile")),
                     ("tile_4byte", forced("tile_4byte")),
                     ("tile256", variant_fn(lib, "tile256", bits, ops)),
                     ("tile64", variant_fn(lib, "tile64", bits, ops)),
                     ("f", variant_fn(lib, "f", bits, ops)), ("g", variant_fn(lib, "g", bits, ops))):
        if not torch.equal(fn(7), want):
            raise RuntimeError(f"K7's {name} form disagrees with the plain version")
    del want
    fns = {"column": forced("column"), "a": variant_fn(lib, "a", bits, ops),
           "b": variant_fn(lib, "b", bits, ops), "tile": forced("tile"),
           "tile_4byte": forced("tile_4byte"), "tile256": variant_fn(lib, "tile256", bits, ops),
           "tile64": variant_fn(lib, "tile64", bits, ops), "f": variant_fn(lib, "f", bits, ops),
           "f_plain": variant_fn(lib, "f_plain", bits, ops), "g": variant_fn(lib, "g", bits, ops),
           "d": variant_fn(lib, "d", bits, ops), "e": variant_fn(lib, "e", bits, ops)}
    w = ops[1].shape[0]
    result = {"card": card, "shape": f"{w}x{BATCH}",
              "bound_ms": 4 * (w + 1) * BATCH / HBM_BYTES_PER_S * 1e3,
              "split": in_turns(fns, seeds)}

    sweep = {}
    for w in SWEEP_WS:
        ops = operands(w, 16, dev)
        tile = variant_fn(lib, "tile128", bits, ops)
        if not torch.equal(tile(9), ek._philox_cuda(9, bits, *ops, path="column")):
            raise RuntimeError(f"the tile path disagrees with the column path at W={w}")
        fns = {"column": lambda s: ek._philox_cuda(s, bits, *ops, path="column"),
               "tile128": tile, "f": variant_fn(lib, "f", bits, ops),
               "g": variant_fn(lib, "g", bits, ops)}
        if w * (256 + 3) * 4 <= MAX_SMEM:      # the 256-column tile fits a block
            fns["tile256"] = variant_fn(lib, "tile256", bits, ops)
        sweep[w] = {"bound_ms": 4 * (w + 1) * BATCH / HBM_BYTES_PER_S * 1e3,
                    **in_turns(fns, seeds, 1)}
        torch.cuda.empty_cache()
    result["sweep"] = sweep
    result["ptxas"] = [r for r in _build.kernel_resources() if "philox" in r["kernel"]
                       or "encrypt_kernelILb1E" in r["kernel"]]
    if args.sass:
        result["sass"] = sass_counts(args.sass)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
