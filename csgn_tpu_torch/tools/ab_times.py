"""Kernel times for comparing two trees of the port on one card, in turns.

    PYTHONPATH=<tree> python3 csgn_tpu_torch/tools/ab_times.py {encrypt,benes,benes-wide,benes-lanes}

times the kernels of the csgn_tpu_torch package found first on the path
(the tree's), through the public wrappers, and prints one JSON line.  Run it
for the parent and the change in the order parent, change, change, parent
within one call on the card, so both see the same card and clock.  Each
figure is the ms per call of a run of five launches over distinct inputs
after one untimed call (CUDA events), three runs a kernel:

  * ``encrypt``: K4 (counter engine) and K7 (Philox) at Context(1247, 16),
    40 x 2^22;
  * ``benes``: K8 on the register path at n = 1247 over 2^20 chunks, alone
    and right after its plain version;
  * ``benes-wide``: K8 and K12 on the wide path at n = 20000 over 2^14
    chunks, and K8 with its global-scratch form forced;
  * ``benes-lanes``: K8 as routed at n in {2049, 4095, 8191, 16383} over
    2^20 chunks and at n in {20000, 40000} over 2^14, each in turns with
    the paths forced that the tree has for that width (``--forced``), and
    its operation bound (`network_ops` over 132 SMs x 64 INT32 lanes at the
    maximum SM clock).

It needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

import csgn_tpu_torch
from csgn_tpu_torch import Context, Permutation, SecretKey
from csgn_tpu_torch.ops import benes_kernels, encrypt_kernels


def run_ms(fn, inputs) -> float:
    """ms per call of one run of `fn` over `inputs`, after one untimed call."""
    fn(inputs[-1])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for x in inputs:
        fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(inputs)


def _words(ctx: Context, chunks: int, count: int, dev) -> list:
    valid = torch.from_numpy(ctx.valid_mask.view(np.int32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    return [torch.randint(0, 1 << 32, (ctx.words32, chunks), dtype=torch.int64, device=dev,
                          generator=gen).to(torch.int32) & valid[:, None] for _ in range(count)]


def encrypt_times(dev) -> dict:
    ctx = Context(1247, 16)
    sk = SecretKey(ctx, np.random.default_rng(0).choice(ctx.n, ctx.d, replace=False), dev)
    bits = torch.randint(0, 2, (1 << 22,), dtype=torch.int32, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    args = (bits, *sk.encrypt_operands)
    seeds = list(range(1, 6))
    return {name: [run_ms(fn, seeds) for _ in range(3)] for name, fn in (
        ("k4", lambda s: encrypt_kernels.encrypt_bits_counter(s, *args)),
        ("k7", lambda s: encrypt_kernels.encrypt_bits_philox(s, *args)))}


def benes_times(dev) -> dict:
    ctx = Context(1247, 16)
    plan = Permutation.random(ctx, torch.Generator().manual_seed(20261016)).benes_plan()
    xs = _words(ctx, 1 << 20, 5, dev)
    k8 = lambda x: benes_kernels.apply_benes(x, plan)  # noqa: E731
    out = {"k8": [run_ms(k8, xs) for _ in range(3)], "k8_after_plain": []}
    for _ in range(2):
        run_ms(lambda x: benes_kernels.apply_benes_plain(x, plan), xs)
        out["k8_after_plain"].append(run_ms(k8, xs))
    return out


def benes_wide_times(dev) -> dict:
    n = 20000
    ctx = Context(n, 16)
    gen = torch.Generator().manual_seed(5)
    p = Permutation.random(n, gen)
    plan = p.benes_plan()
    sk = SecretKey(ctx, torch.randperm(n, generator=gen)[:ctx.d].numpy(), dev)
    key = sk.apply_permutation(p).mask_words
    xs = _words(ctx, 1 << 14, 5, dev)
    if not torch.equal(benes_kernels.apply_benes(xs[0], plan),
                       benes_kernels.apply_benes_plain(xs[0], plan)):
        raise RuntimeError("the wide path disagrees with its plain version")
    return {name: [run_ms(fn, xs) for _ in range(3)] for name, fn in (
        ("k8", lambda x: benes_kernels.apply_benes(x, plan)),
        ("k12", lambda x: benes_kernels.apply_benes_decrypt(x, plan, key)),
        ("global", lambda x: benes_kernels._benes_cuda("apply_benes", x, plan, 0,
                                                       path="global")[0]))}


def benes_lanes_times(dev, forced) -> dict:
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True, text=True,
                               check=True, timeout=60).stdout.split()[0])
    out = {}
    for n, chunks in ((2049, 1 << 20), (4095, 1 << 20), (8191, 1 << 20), (16383, 1 << 20),
                      (20000, 1 << 14), (40000, 1 << 14)):
        ctx = Context(n, 16)
        plan = Permutation.random(n, torch.Generator().manual_seed(n)).benes_plan()
        xs = _words(ctx, chunks, 5, dev)
        ops = benes_kernels.network_ops(plan) * chunks  # the operation bound, 132 SMs x 64 lanes
        row = {"path": benes_kernels.benes_path(plan.words_pad),
               "bound_ms": ops / (132 * 64 * mhz * 1e6) * 1e3,
               "routed": [run_ms(lambda x: benes_kernels.apply_benes(x, plan), xs)]}
        for path in forced:
            try:
                row[path] = [run_ms(lambda x: benes_kernels._benes_cuda(
                    "apply_benes", x, plan, 0, path=path)[0], xs)]
            except (KeyError, RuntimeError, ValueError) as e:   # a path the tree lacks or
                # that does not take this width
                row[path] = str(e)[:80]
        for path in forced[::-1]:
            if isinstance(row[path], list):
                row[path].append(run_ms(lambda x: benes_kernels._benes_cuda(
                    "apply_benes", x, plan, 0, path=path)[0], xs))
        row["routed"].append(run_ms(lambda x: benes_kernels.apply_benes(x, plan), xs))
        out[n] = row
        del xs
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("encrypt", "benes", "benes-wide", "benes-lanes"))
    parser.add_argument("--forced", default="", help="benes-lanes: comma-separated paths to "
                        "time in turns with the routed one")
    args = parser.parse_args()
    dev = torch.device("cuda", 0)
    fns = {"encrypt": encrypt_times, "benes": benes_times, "benes-wide": benes_wide_times,
           "benes-lanes": lambda d: benes_lanes_times(d, [p for p in args.forced.split(",") if p])}
    print(json.dumps({"package": csgn_tpu_torch.__file__, args.what: fns[args.what](dev)}))


if __name__ == "__main__":
    main()
