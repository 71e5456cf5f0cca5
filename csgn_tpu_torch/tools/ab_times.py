"""Kernel times for comparing two trees of the port on one card, in turns.

    PYTHONPATH=<tree> python3 csgn_tpu_torch/tools/ab_times.py {encrypt,benes,benes-wide,benes-lanes,muldec}

times the kernels of the csgn_tpu_torch package found first on the path
(the tree's), through the public wrappers, and prints one JSON line.  Run it
for the parent and the change in the order parent, change, change, parent
within one call on the card, so both see the same card and clock.  Each
figure is the ms per call of a run of five launches over distinct inputs
after one untimed call (CUDA events), three runs a kernel:

  * ``encrypt``: K4 (counter engine), K7 (Philox) and, where the tree has
    it, K14 (the JAX package's default engine) at Context(1247, 16),
    40 x 2^22, K7 also on each of its paths forced (tile, column) where the
    tree has them, and K13 (the Philox stream dump) at 130 x 2^20;
  * ``benes``: the register path at n = 1247: K8 over 2^20 chunks, alone
    and right after its plain version, K12 over the same, K9 over 64
    elements of 2^14 chunks, each on its own plan, and K8 over a 4096 x 4096
    product's 2^24 chunks, a run cycling four plans;
  * ``benes-wide``: K8 and K12 on the wide path at n = 20000 over 2^14
    chunks, and K8 with its global-scratch form forced;
  * ``benes-lanes``: K8 as routed at n in {2049, 4095, 8191, 16383} over
    2^20 chunks and at n in {20000, 40000} over 2^14, each in turns with
    the paths forced that the tree has for that width (``--forced``), and
    its operation bound (`network_ops` over 132 SMs x 64 INT32 lanes at the
    maximum SM clock);
  * ``muldec``: the fused multiply+decrypt (`mul_decrypt`) in turns with
    `mul_chunks` at the bulk cells' shapes, 4096 x 4096, 1021 x 16411,
    151,663 x 111 and 16 x 2^19, at Context(1247, 16), on operands whose
    every chunk matches the key (the count reads every nonzero mask row of
    a and b) and, for the fused op, on random words; with each shape's mode,
    byte bound (operands read and product written once over 3.35 TB/s) and
    the launches of one fused call by ``LAUNCHES`` key.

It needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

import csgn_tpu_torch
from csgn_tpu_torch import Context, Permutation, SecretKey, rng
from csgn_tpu_torch.ops import benes_kernels, encrypt_kernels, kernels
from csgn_tpu_torch.ops import permute_benes as pb


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
    out = {name: [run_ms(fn, seeds) for _ in range(3)] for name, fn in (
        ("k4", lambda s: encrypt_kernels.encrypt_bits_counter(s, *args)),
        ("k7", lambda s: encrypt_kernels.encrypt_bits_philox(s, *args)),
        ("k13", lambda s: encrypt_kernels.philox_streams(s, 1 << 20, 130, dev)))}
    for path in ("tile", "column"):   # K7's paths, forced, where the tree has them
        forced = getattr(encrypt_kernels, "_philox_cuda", None)
        out[f"k7_{path}"] = "no forced paths in this tree" if forced is None else [
            run_ms(lambda s: forced(s, *args, path=path), seeds) for _ in range(3)]
    k14 = getattr(encrypt_kernels, "encrypt_bits_threefry", None)
    out["k14"] = "no K14 in this tree" if k14 is None else [
        run_ms(lambda k: k14(k, *args), [rng.key(s) for s in seeds]) for _ in range(3)]
    return out


def benes_times(dev) -> dict:
    ctx = Context(1247, 16)
    p = Permutation.random(ctx, rng.key(20261016))
    plan = p.benes_plan()
    xs = _words(ctx, 1 << 20, 5, dev)
    k8 = lambda x: benes_kernels.apply_benes(x, plan)  # noqa: E731
    out = {"k8": [run_ms(k8, xs) for _ in range(3)], "k8_after_plain": []}
    for _ in range(2):
        run_ms(lambda x: benes_kernels.apply_benes_plain(x, plan), xs)
        out["k8_after_plain"].append(run_ms(k8, xs))
    key = SecretKey.generate(ctx, rng.key(6), dev).apply_permutation(p).mask_words
    out["k12"] = [run_ms(lambda x: benes_kernels.apply_benes_decrypt(x, plan, key), xs)
                  for _ in range(3)]
    del xs
    fleet = pb.stack_plans([Permutation.random(ctx, rng.key(100 + i)).benes_plan()
                            for i in range(64)])
    xs = [torch.stack(_words(ctx, 1 << 14, 64, dev)) for _ in range(5)]
    out["k9_64x2p14"] = [run_ms(lambda x: benes_kernels.apply_benes_batch(x, fleet), xs)
                         for _ in range(3)]
    del xs
    plans = [Permutation.random(ctx, rng.key(900 + i)).benes_plan() for i in range(4)]
    x = _words(ctx, 1 << 24, 1, dev)[0]
    out["k8_2p24"] = [run_ms(lambda q: benes_kernels.apply_benes(x, q), plans)
                      for _ in range(3)]
    return out


def benes_wide_times(dev) -> dict:
    n = 20000
    ctx = Context(n, 16)
    p = Permutation.random(n, rng.key(5))
    plan = p.benes_plan()
    sk = SecretKey.generate(ctx, rng.key(6), dev)
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
        plan = Permutation.random(n, rng.key(n)).benes_plan()
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


def muldec_times(dev) -> dict:
    ctx = Context(1247, 16)
    w = ctx.words32
    sk = SecretKey.generate(ctx, rng.key(11), dev)
    m = sk.mask_words
    hit = torch.from_numpy(sk.mask.view(np.int32)).to(dev)[:, None]
    out = {}
    for t1, t2 in ((4096, 4096), (1021, 16411), (151663, 111), (16, 1 << 19)):
        rand = list(zip(_words(ctx, t1, 5, dev), _words(ctx, t2, 5, dev)))
        every = [(x | hit, y | hit) for x, y in rand]
        before = dict(kernels.LAUNCHES)
        kernels.mul_decrypt(*every[0], m)
        launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
        fns = {"fused": lambda p: kernels.mul_decrypt(p[0], p[1], m),
               "mul_chunks": lambda p: kernels.mul_chunks(p[0], p[1])}
        row = {"mode": kernels.mul_mode(w, t1, t2, True), "launches": launched,
               "bound_ms": 4 * w * (t1 + t2 + t1 * t2) / 3.35e12 * 1e3,
               **{name: [] for name in fns}, "fused_random": []}
        for _ in range(3):
            for name, fn in fns.items():
                row[name].append(run_ms(fn, every))
            row["fused_random"].append(run_ms(fns["fused"], rand))
        out[f"{t1}x{t2}"] = row
        del rand, every
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("encrypt", "benes", "benes-wide", "benes-lanes",
                                         "muldec"))
    parser.add_argument("--forced", default="", help="benes-lanes: comma-separated paths to "
                        "time in turns with the routed one")
    args = parser.parse_args()
    dev = torch.device("cuda", 0)
    fns = {"encrypt": encrypt_times, "benes": benes_times, "benes-wide": benes_wide_times,
           "benes-lanes": lambda d: benes_lanes_times(d, [p for p in args.forced.split(",") if p]),
           "muldec": muldec_times}
    print(json.dumps({"package": csgn_tpu_torch.__file__, args.what: fns[args.what](dev)}))


if __name__ == "__main__":
    main()
