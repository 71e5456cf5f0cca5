#!/usr/bin/env python3
"""The port's public paths on one NVIDIA GPU, each kernel held to its plain
version on the paths' own inputs, and every kernel timed.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It runs the tests of tests/test_torch_cuda.py that drive a public path at
full size (those marked ``@_path(name, ...)``: main, rotation, circuit,
entry, sharded, programs, bench, order), in one pytest session, with:

  * every kernel wrapper (K1-K5, K7, K8/K9/K12, K13, K14) replaced, in every
    module of csgn_tpu_torch that holds it, by one that also runs the
    wrapper's plain torch version on the same inputs on the card and fails
    the run unless the two agree bit for bit;
  * ``LAUNCHES`` zeroed before each test, and its counts summed by path
    (each marked test also fails unless its path's kernels counted
    launches);
  * for each ``LAUNCHES`` key, the inputs of the largest call that counted
    under it kept on the host.

Then each key's kernel and plain version are timed in turns on those
inputs (CUDA events; plain, kernel, library, then back) beside the least
time the card could take (bytes over HBM's 3.35 TB/s, or integer
operations over 132 SMs x 64 INT32 lanes at the maximum SM clock); the
library is, for the multiply and the write anchor only, the one PyTorch
call that does the same job.  The last
lines are ``{"kernels": [...]}`` (per key: shape, ms, plain_ms, bound_ms,
bound_by, library_ms, launches, launches_by_path, checked) and
``{"ok": ...}``; the exit code is pytest's, or 1 if a kernel and its plain
version disagreed.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

import csgn_tpu_torch  # noqa: F401  (every module that holds a wrapper, before patching)
from csgn_tpu_torch.ops import benes_kernels as bk
from csgn_tpu_torch.ops import core
from csgn_tpu_torch.ops import encrypt_kernels as ek
from csgn_tpu_torch.ops import kernels
from csgn_tpu_torch.ops._build import LAUNCHES

HBM_BYTES_PER_S = 3.35e12
SMS, INT32_LANES = 132, 64
REPS = 5                        # back-to-back calls in each timed run

# Integer operations per 32-bit lane of the generators: a threefry2x32 call
# 72 (a round's add, funnel shift and xor 3, a key injection 2), a
# Philox-4x32 call 40 (a round's two IMAD.WIDE and two LOP3), the fix-up of
# a word 3, of a nonzero mask row on K7's tile path 4.
THREEFRY_OPS, PHILOX_OPS, FIXUP_OPS, TILE_FIXUP_OPS = 72, 40, 3, 4


def _decrypt_plain(words, mask, *, return_count=False):
    count = core.chunk_matches(words, mask).sum(dim=-1)
    return count if return_count else count & 1


# (module, wrapper, its plain torch version with the wrapper's signature)
WRAPPERS = [
    (kernels, "mul_chunks", kernels.mul_chunks_plain),
    (kernels, "mul_decrypt", kernels.mul_decrypt_plain),
    (kernels, "decrypt_parity", _decrypt_plain),
    (kernels, "chunk_matches", kernels.chunk_matches_plain),
    (kernels, "fill_anchor", kernels.fill_anchor_plain),
    (bk, "apply_benes", bk.apply_benes_plain),
    (bk, "apply_benes_batch", bk.apply_benes_batch_plain),
    (bk, "apply_benes_decrypt", bk.apply_benes_decrypt_plain),
    (ek, "encrypt_bits_counter", ek.encrypt_bits_counter_plain),
    (ek, "encrypt_bits_philox", ek.encrypt_bits_philox_plain),
    (ek, "encrypt_bits_threefry", ek.encrypt_bits_threefry_plain),
    (ek, "philox_streams",
     lambda seed, batch, rows, device=None: ek.philox_streams_plain(
         seed, batch, rows, device).to(torch.int32)),
]


def _library_and(a, b, *_):
    return torch.bitwise_and(a[..., :, None], b[..., None, :])


def _library_fill(seed, t1, t2, w, device=None):
    return torch.empty((w, t1 * t2), dtype=torch.int32, device=device).fill_(seed & 0x7FFFFFFF)


LIBRARY = {"mul_chunks": _library_and, "fill_anchor": _library_fill}


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensors(x)


def _moved(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_moved(x, device) for x in obj)
    return obj


def _ops(wrapper: str, args) -> int:
    """Integer operations of a call, by the counts above (0: bytes bound it)."""
    if wrapper.startswith("apply_benes"):
        words, plan = args[0], args[1]
        per_chunk = bk.network_ops(plan)
        chunks = words.shape[-1] * (1 if wrapper == "apply_benes_batch"
                                    else words.numel() // words.shape[-1] // words.shape[-2])
        return (sum(per_chunk) if isinstance(per_chunk, list) else per_chunk) * chunks
    if wrapper == "philox_streams":
        return args[1] * -(-args[2] // 4) * PHILOX_OPS
    if wrapper.startswith("encrypt_bits"):
        batch, mask = args[1].shape[0], args[3]
        w = mask.shape[0]
        per = {"encrypt_bits_counter": (w + 3) // 2 * THREEFRY_OPS + FIXUP_OPS * w,
               "encrypt_bits_threefry": (w + 3) * THREEFRY_OPS + FIXUP_OPS * w,
               "encrypt_bits_philox": -(-(w + 2) // 4) * PHILOX_OPS
               + TILE_FIXUP_OPS * int((mask != 0).sum())}
        return batch * per[wrapper]
    return 0


def _bytes(wrapper: str, args, out) -> int:
    """Bytes read and written: every tensor in and out once, but a decrypt
    reads only the mask's nonzero rows."""
    if wrapper in ("decrypt_parity", "chunk_matches"):
        words, mask = args
        return words.nbytes * int((mask != 0).sum()) // mask.shape[0] + mask.nbytes
    return sum(t.nbytes for t in (*_tensors(args), *_tensors(out)))


def _same(got, want) -> bool:
    got, want = list(_tensors(got)), list(_tensors(want))
    return len(got) == len(want) and all(
        g.shape == w.shape and torch.equal(g, w.to(g.device, g.dtype)) for g, w in zip(got, want))


class Smoke:
    """The pytest plugin and the wrappers' record: launches by path, calls
    checked and failed by wrapper, the largest call by LAUNCHES key."""

    def __init__(self):
        self.by_path: dict[str, dict[str, int]] = {}
        self.by_test: dict[str, dict[str, int]] = {}
        self.checked: dict[str, int] = {}
        self.wrong: list[str] = []
        self.largest: dict[str, tuple] = {}
        self._inside = False            # in a plain version: its calls go unchecked
        self.test = ""

    def install(self) -> None:
        for module, name, plain in WRAPPERS:
            orig = getattr(module, name)
            checked = self._checked(name, orig, plain)
            for mod in list(sys.modules.values()):
                if not getattr(mod, "__name__", "").startswith("csgn_tpu_torch"):
                    continue
                for attr, value in list(vars(mod).items()):   # names and tables of them
                    if value is orig:
                        setattr(mod, attr, checked)
                    elif isinstance(value, dict):
                        value.update({k: checked for k, v in value.items() if v is orig})

    def _checked(self, name, orig, plain):
        def run(*args, **kwargs):
            on_card = any(t.is_cuda for t in _tensors(args)) or name in ("fill_anchor",
                                                                          "philox_streams")
            if self._inside or not on_card:
                return orig(*args, **kwargs)
            before = dict(LAUNCHES)
            out = orig(*args, **kwargs)
            self._inside = True
            try:
                ok = _same(out, plain(*args, **kwargs))
            finally:
                self._inside = False
            self.checked[name] = self.checked.get(name, 0) + 1
            if not ok:
                self.wrong.append(f"{self.test}: {name} {[tuple(t.shape) for t in _tensors(args)]}")
            nbytes = _bytes(name, args, out)
            for key in (k for k in LAUNCHES if LAUNCHES[k] != before[k]):
                if nbytes > self.largest.get(key, (0,))[0]:
                    self.largest[key] = (nbytes, name, orig, plain, _moved(args, "cpu"), kwargs,
                                         _ops(name, args))
            return out
        return run

    def pytest_collection_modifyitems(self, config, items):
        keep = [it for it in items if hasattr(getattr(it, "obj", None), "path")]
        config.hook.pytest_deselected(items=[it for it in items if it not in keep])
        items[:] = keep

    @pytest.hookimpl(hookwrapper=True)
    def pytest_runtest_call(self, item):
        self.test = item.nodeid
        for key in LAUNCHES:
            LAUNCHES[key] = 0
        yield
        launched = {k: v for k, v in LAUNCHES.items() if v}
        self.by_test[item.nodeid] = launched
        path = self.by_path.setdefault(item.obj.path, {})
        for k, v in launched.items():
            path[k] = path.get(k, 0) + v


def _run_ms(fn, args, kwargs) -> float:
    """ms a call over REPS calls back to back, after one untimed call that
    keeps the card busy while the host queues the window's start."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn(*args, **kwargs)
    start.record()
    for _ in range(REPS):
        fn(*args, **kwargs)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def _times(smoke: Smoke, int_ops_per_s: float) -> list[dict]:
    rows = []
    for key, (nbytes, name, orig, plain, args, kwargs, ops) in sorted(smoke.largest.items()):
        args = _moved(args, "cuda")
        fns = {"plain": plain, "kernel": orig}
        if name in LIBRARY:
            fns["library"] = LIBRARY[name]
        for fn in fns.values():                       # warm-up, outside the windows
            fn(*args, **kwargs)
        ms = {k: [] for k in fns}
        for k in (*fns, *reversed(fns)):               # in turns: plain, kernel, ..., plain
            ms[k].append(_run_ms(fns[k], args, kwargs))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / int_ops_per_s * 1e3
        rows.append({
            "name": key, "wrapper": name,
            "shape": [list(t.shape) for t in _tensors(args)],
            "ms": sum(ms["kernel"]) / 2, "plain_ms": sum(ms["plain"]) / 2,
            "library_ms": sum(ms["library"]) / 2 if "library" in ms else None,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "ops",
            "launches": sum(p.get(key, 0) for p in smoke.by_path.values()),
            "launches_by_path": {path: p.get(key, 0) for path, p in smoke.by_path.items()},
            "checked": smoke.checked.get(name, 0),
        })
        del args
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    card, limit_w, sm_mhz = (s.strip() for s in smi.split(","))
    int_ops_per_s = SMS * INT32_LANES * float(sm_mhz) * 1e6
    print(f"[device] {card}, power limit {limit_w} W, max SM clock {sm_mhz} MHz; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    smoke = Smoke()
    smoke.install()
    rc = pytest.main(["--noconftest", "-p", "no:cacheprovider", "-q",
                      "tests/test_torch_cuda.py"], plugins=[smoke])
    print(f"[paths] {json.dumps(smoke.by_path)}")
    print(f"[tests] {json.dumps(smoke.by_test)}")
    print(f"[check] calls held to plain: {json.dumps(smoke.checked)}; "
          f"disagreed: {smoke.wrong or 'none'}")
    rows = _times(smoke, int_ops_per_s)
    for r in rows:
        print(f"[time] {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              + (f", library {r['library_ms']:.4f} ms" if r["library_ms"] is not None else "")
              + f"; {card}, {limit_w} W")
    print(json.dumps({"kernels": rows}))
    ok = rc == 0 and not smoke.wrong
    print(json.dumps({"ok": ok, "pytest_exit": int(rc), "device": card, "power_limit_w": limit_w}))
    return 0 if ok else int(rc) or 1


if __name__ == "__main__":
    sys.exit(main())
