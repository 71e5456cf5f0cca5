#!/usr/bin/env python3
"""Smoke run of csgn_tpu_torch on one NVIDIA GPU (written for the H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing lines tagged [device] / [build] / [check] / [main] /
[time]:

  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: the CUDA kernels from csgn_tpu_torch/csrc, with the seconds taken;
  3. each kernel against its plain torch version on the card, bit-exact, at
     small and ragged shapes and at the main path's full size;
  4. the main path through the public API at Context(1247, 16): key, two
     4096-bit encrypt batches, decrypt_batch / decrypt, the fused
     mul_and_decrypt over the 16.7 M-chunk product, ``*`` and ``+``; every
     kernel's launch count must rise during this phase;
  5. timings of each kernel and its plain version at the main path's shapes
     (CUDA events, warm-up, median of distinct inputs; nothing is asserted).

Then one JSON line with the kernels, and last the device JSON line.  Any
failure raises and exits non-zero with no result; so does a machine without
a CUDA device.  All data is made from fixed seeds.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from csgn_tpu_torch import Ciphertext, Context, SecretKey
from csgn_tpu_torch.layout import words_to_numpy
from csgn_tpu_torch.ops import _build, core, encrypt_kernels, kernels

SEED = 20261016
M32 = 0xFFFFFFFF
MAIN_T = 4096             # bits per encrypt batch on the main path
DEC_CHUNKS = MAIN_T * MAIN_T  # K3 at the product's size: 2^24 chunks, 2.68 GB at W = 40
ENC_BATCH = 1 << 22       # K4 at a large batch
REPS = 5

# wrapper -> (source, TPU kernel it replaces)
KERNELS = {
    "mul_chunks": ("csgn_tpu_torch/csrc/mul.cu", "csgn_tpu/ops/kernels.py:84"),
    "mul_decrypt": ("csgn_tpu_torch/csrc/mul.cu", "csgn_tpu/ops/kernels.py:158"),
    "decrypt_parity": ("csgn_tpu_torch/csrc/decrypt.cu", "csgn_tpu/ops/kernels.py:631"),
    "chunk_matches": ("csgn_tpu_torch/csrc/decrypt.cu", "csgn_tpu/ops/kernels.py:631"),
    "encrypt_bits_counter": ("csgn_tpu_torch/csrc/encrypt.cu",
                             "csgn_tpu/ops/encrypt_pallas.py:250"),
}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def max_abs_err(x: torch.Tensor, y: torch.Tensor) -> int:
    """Largest |x - y| over the uint32 values of two int32 word tensors."""
    require(x.shape == y.shape, f"shape {tuple(x.shape)} != {tuple(y.shape)}")
    diff = x != y
    if not bool(diff.any()):
        return 0
    return int(((x[diff].long() & M32) - (y[diff].long() & M32)).abs().max())


def rand_words(ctx: Context, chunks: int, gen: torch.Generator, dev) -> torch.Tensor:
    """Random canonical words [W, chunks] made on the card from `gen`."""
    out = torch.empty((ctx.words32, chunks), dtype=torch.int32, device=dev)
    for r in range(ctx.words32):
        row = torch.randint(0, 1 << 32, (chunks,), dtype=torch.int64, device=dev, generator=gen)
        out[r] = row.to(torch.int32)
    valid = torch.from_numpy(ctx.valid_mask.view(np.int32)).to(dev)
    return out & valid[:, None]


def force(words: torch.Tensor, cols, mask: torch.Tensor) -> torch.Tensor:
    words[:, cols] |= mask[:, None]
    return words


# ---------------------------------------------------------------------------
# Phase 3: kernels vs plain, bit-exact
# ---------------------------------------------------------------------------


def check_kernels(ctx, sk, gen, dev, errs: dict) -> None:
    m = sk.mask_words
    saw_parity_one = False
    for t1, t2 in [(1, 1), (3, 5), (13, 7), (9, 33), (128, 130), (MAIN_T, MAIN_T)]:
        a = force(rand_words(ctx, t1, gen, dev), slice(0, t1, 2), m)
        b = force(rand_words(ctx, t2, gen, dev), slice(0, t2, 3), m)
        want = kernels.mul_chunks_plain(a, b)
        e1 = max_abs_err(kernels.mul_chunks(a, b), want)
        prod, count = kernels.mul_decrypt(a, b, m, return_count=True)
        _, parity = kernels.mul_decrypt(a, b, m)
        _, want_count = kernels.mul_decrypt_plain(a, b, m, return_count=True)
        e2 = max(max_abs_err(prod, want), abs(int(count) - int(want_count)),
                 abs(int(parity) - (int(want_count) & 1)))
        errs["mul_chunks"] = max(errs["mul_chunks"], e1)
        errs["mul_decrypt"] = max(errs["mul_decrypt"], e2)
        require(e1 == 0 and e2 == 0, f"K1/K2 disagree with plain at {t1}x{t2}")
        require(int(count) > 0, f"no forced matches counted at {t1}x{t2}")
        saw_parity_one |= int(parity) == 1
        print(f"[check] mul_chunks + mul_decrypt {t1}x{t2}: bit-equal, count {int(count)} "
              f"parity {int(parity)}")
        del a, b, want, prod
    require(saw_parity_one, "no K2 case had parity 1")

    for chunks in [1, 19, 1025, DEC_CHUNKS]:
        words = force(rand_words(ctx, chunks, gen, dev), slice(0, chunks, 7), m)
        e3 = abs(int(kernels.decrypt_parity(words, m))
                 - int(kernels.decrypt_parity_plain(words, m)))
        got = kernels.chunk_matches(words, m)
        e4 = max_abs_err(got, kernels.chunk_matches_plain(words, m))
        errs["decrypt_parity"] = max(errs["decrypt_parity"], e3)
        errs["chunk_matches"] = max(errs["chunk_matches"], e4)
        require(e3 == 0 and e4 == 0, f"K3 disagrees with plain at {chunks} chunks")
        print(f"[check] decrypt_parity + chunk_matches {chunks} chunks: equal, "
              f"{int(got.sum())} matches")
        del words, got

    for batch in [1, 129, ENC_BATCH]:
        bits = torch.randint(0, 2, (batch,), dtype=torch.int32, device=dev, generator=gen)
        args = (bits, *sk.encrypt_operands)
        got = encrypt_kernels.encrypt_bits_counter(SEED + batch, *args)
        e5 = max_abs_err(got, encrypt_kernels.encrypt_bits_counter_plain(SEED + batch, *args))
        errs["encrypt_bits_counter"] = max(errs["encrypt_bits_counter"], e5)
        require(e5 == 0, f"K4 disagrees with plain at batch {batch}")
        require(torch.equal(kernels.chunk_matches(got, m), bits), "encrypt round trip failed")
        require(not bool((got & ~sk.encrypt_operands[2][:, None]).any()), "padding bits set")
        print(f"[check] encrypt_bits_counter batch {batch}: bit-equal, round trip ok, "
              f"padding zero")
        del got, bits


# ---------------------------------------------------------------------------
# Phase 4: the main path at full size, through the public API
# ---------------------------------------------------------------------------


def odd_bits(rng: np.random.Generator, n: int) -> np.ndarray:
    bits = rng.integers(0, 2, n).astype(np.int32)
    if bits.sum() % 2 == 0:
        bits[0] ^= 1
    return bits


def main_path(ctx, indices, rng, dev) -> dict:
    bits1, bits2 = odd_bits(rng, MAIN_T), odd_bits(rng, MAIN_T)
    xor1, xor2 = int(bits1.sum() % 2), int(bits2.sum() % 2)
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    sk = SecretKey(ctx, indices, device=dev)
    c1 = Ciphertext(sk.encrypt_batch(bits1, SEED + 1), ctx)
    c2 = Ciphertext(sk.encrypt_batch(bits2, SEED + 2), ctx)
    dec1 = sk.decrypt_batch(c1.wt).cpu().numpy()
    dec2 = sk.decrypt_batch(c2.wt).cpu().numpy()
    d1, d2 = int(sk.decrypt(c1)), int(sk.decrypt(c2))
    prod, p = sk.mul_and_decrypt(c1, c2)
    dprod = int(sk.decrypt(prod))
    prod2 = c1 * c2
    same = torch.equal(prod.wt, prod2.wt)
    dsum = int(sk.decrypt(c1 + c2))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    require(np.array_equal(dec1, bits1) and np.array_equal(dec2, bits2),
            "decrypt_batch != encrypted bits")
    require((d1, d2) == (xor1, xor2) == (1, 1), f"decrypt {d1},{d2} != xor {xor1},{xor2}")
    require(int(p) == (xor1 & xor2) == 1, f"mul_and_decrypt parity {int(p)} != 1")
    require(dprod == int(p), "decrypt(prod) != mul_and_decrypt parity")
    require(same, "mul_and_decrypt product != c1 * c2")
    require(dsum == xor1 ^ xor2, "decrypt(c1 + c2) != xor1 ^ xor2")
    require(tuple(prod.wt.shape) == (ctx.words32, MAIN_T * MAIN_T), "product shape")
    require(max_abs_err(prod.wt, core.mul_chunks(c1.wt, c2.wt)) == 0,
            "product != plain cross-product on the card")
    idle = [k for k, v in launches.items() if v == 0]
    require(not idle, f"main path never launched: {idle}")
    print(f"[main] Context({ctx.n},{ctx.d}) W={ctx.words32}: 2 x {MAIN_T}-bit encrypt, "
          f"product {MAIN_T * MAIN_T} chunks ({prod.nbytes / 1e9:.2f} GB); "
          f"decrypt(c1)={d1} decrypt(c2)={d2} mul_and_decrypt={int(p)} "
          f"decrypt(prod)={dprod} decrypt(c1+c2)={dsum}; {seconds:.3f} s host wall")
    print(f"[main] launches {json.dumps(launches)}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")

    # A small prefix against the CPU path (held to csgn_tpu by the CPU tests):
    # counters are global, so the first 64 columns do not depend on the batch.
    cpu_sk = SecretKey(ctx, indices, device="cpu")
    cpu_c1 = cpu_sk.encrypt_batch(bits1[:64], SEED + 1)
    require(np.array_equal(words_to_numpy(c1.wt[:, :64]), words_to_numpy(cpu_c1)),
            "card encrypt != CPU encrypt on the first 64 columns")
    print("[main] first 64 encrypted columns equal the CPU path's")
    return launches


# ---------------------------------------------------------------------------
# Phase 5: timings
# ---------------------------------------------------------------------------


def time_pair(kernel_fn, plain_fn, inputs) -> tuple[float, float]:
    """Median ms of kernel and plain over distinct inputs, in turns
    (plain, kernel, kernel, plain, ...), after one warm-up of each."""
    kernel_fn(*inputs[0])
    plain_fn(*inputs[0])
    torch.cuda.synchronize()
    times = {"kernel": [], "plain": []}
    for i, args in enumerate(inputs):
        order = [("plain", plain_fn), ("kernel", kernel_fn)]
        for name, fn in order if i % 2 == 0 else order[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return statistics.median(times["kernel"]), statistics.median(times["plain"])


def timings(ctx, sk, gen, dev, card: str) -> dict:
    m = sk.mask_words
    w = ctx.words32
    out = {}

    def report(name, shape, nbytes, ms, plain_ms, extra=""):
        out[name] = {"shape": shape, "ms": ms, "plain_ms": plain_ms}
        print(f"[time] {name} {shape}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), "
              f"plain {plain_ms:.4f} ms ({nbytes / plain_ms / 1e6:.1f} GB/s){extra}; {card}")

    # Distinct inputs are distinct real ciphertexts: a fresh chunk of bit 1
    # matches the mask, so about a quarter of each product's chunks match,
    # as on the main path.
    def fresh_batch(seed):
        bits = torch.randint(0, 2, (MAIN_T,), dtype=torch.int32, device=dev, generator=gen)
        return sk.encrypt_batch(bits, seed)

    ab = [(fresh_batch(SEED + 10 * k), fresh_batch(SEED + 10 * k + 1)) for k in range(REPS)]
    prod_bytes = w * MAIN_T * MAIN_T * 4
    shape = f"{MAIN_T}x{MAIN_T}"
    ms, pms = time_pair(lambda x, y: kernels.mul_decrypt(x, y, m),
                        lambda x, y: kernels.mul_decrypt_plain(x, y, m), ab)
    report("mul_decrypt", shape, prod_bytes, ms, pms,
           f", {MAIN_T * MAIN_T / ms / 1e3:.1f} M chunk-ops/s fused")
    ms, pms = time_pair(kernels.mul_chunks, kernels.mul_chunks_plain, ab)
    report("mul_chunks", shape, prod_bytes, ms, pms)

    prods = [(kernels.mul_chunks(x, y),) for x, y in ab]      # DEC_CHUNKS chunks each
    del ab
    ms, pms = time_pair(lambda x: kernels.decrypt_parity(x, m),
                        lambda x: kernels.decrypt_parity_plain(x, m), prods)
    report("decrypt_parity", f"{w}x{DEC_CHUNKS}", w * DEC_CHUNKS * 4, ms, pms,
           " (bytes counted over all W rows; the kernel reads the mask's rows only)")
    del prods

    bits = torch.randint(0, 2, (ENC_BATCH,), dtype=torch.int32, device=dev, generator=gen)
    args = (bits, *sk.encrypt_operands)
    seeds = [(SEED + k,) for k in range(1, REPS + 1)]
    ms, pms = time_pair(lambda s: encrypt_kernels.encrypt_bits_counter(s, *args),
                        lambda s: encrypt_kernels.encrypt_bits_counter_plain(s, *args), seeds)
    report("encrypt_bits_counter", f"{w}x{ENC_BATCH}", w * ENC_BATCH * 4, ms, pms,
           f", {ENC_BATCH / ms / 1e3:.1f} M enc/s")
    fresh = [(encrypt_kernels.encrypt_bits_counter(s, *args),) for (s,) in seeds]
    ms, pms = time_pair(lambda x: kernels.chunk_matches(x, m),
                        lambda x: kernels.chunk_matches_plain(x, m), fresh)
    report("chunk_matches", f"{w}x{ENC_BATCH}", w * ENC_BATCH * 4, ms, pms)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    # Phase 1: device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, capability {torch.cuda.get_device_capability(0)}")

    # Phase 2: build.
    t0 = time.perf_counter()
    _build.lib()
    print(f"[build] {_build.library_path().name} from csgn_tpu_torch/csrc in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")

    ctx = Context(1247, 16)
    rng = np.random.default_rng(SEED)
    indices = rng.choice(ctx.n, ctx.d, replace=False)
    sk = SecretKey(ctx, indices, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # Phase 3: kernels vs plain.
    errs = dict.fromkeys(KERNELS, 0)
    check_kernels(ctx, sk, gen, dev, errs)
    torch.cuda.synchronize()

    # Phase 4: the main path.
    torch.cuda.reset_peak_memory_stats(dev)
    launches = main_path(ctx, indices, rng, dev)
    torch.cuda.empty_cache()

    # Phase 5: timings.
    times = timings(ctx, sk, gen, dev, smi)
    torch.cuda.synchronize()

    rows = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "shape": times[name]["shape"]}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
