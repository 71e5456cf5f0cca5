#!/usr/bin/env python3
"""Smoke run of csgn_tpu_torch on one NVIDIA GPU (written for the H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

With ``--profile`` it also runs phase 4b three more times warm and once
under `torch.profiler`, and prints the rotation path's host wall, device
busy time, idle share and heaviest kernels as [profile] lines.

Phases, each printing lines tagged [device] / [build] / [check] / [main] /
[rotate] / [time]:

  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: the CUDA kernels from csgn_tpu_torch/csrc, with the seconds taken;
  3. each kernel against its plain torch version on the card, bit-exact, at
     small and ragged shapes and at the main path's full size: K1-K4, the
     Beneš kernels K8/K9/K12 at n in {20, 100, 1247} and up to 2^20 chunks,
     and K1-K3 on batched [B, W, C] operands;
  4. the main path through the public API at Context(1247, 16): key, two
     4096-bit encrypt batches, decrypt_batch / decrypt, the fused
     mul_and_decrypt over the 16.7 M-chunk product, ``*`` and ``+``; every
     kernel of this path must be launched during it;
  4b. the key-rotation path at Context(1247, 16): phase 4's product permuted,
     decrypted under the permuted key, permuted back; then a fleet of 64
     128-chunk ciphertexts, multiplied into [64, 40, 16384], decrypted,
     re-keyed under 64 distinct permutations and decrypted under each
     rotated key; K12, which `permute_and_decrypt` does not use (it stays
     staged, as in the JAX package), is called through its ops-level
     function on the rotated product; every kernel of this path must be
     launched during it;
  5. timings of each kernel and its plain version at the paths' shapes
     (CUDA events, warm-up, median of distinct inputs; nothing is asserted).

Then one JSON line with the kernels, and last the device JSON line.  Any
failure raises and exits non-zero with no result; so does a machine without
a CUDA device.  All data is made from fixed seeds.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from csgn_tpu_torch import Ciphertext, CiphertextBatch, Context, Permutation, SecretKey
from csgn_tpu_torch.layout import words_to_numpy
from csgn_tpu_torch.ops import _build, benes_kernels, core, encrypt_kernels, kernels
from csgn_tpu_torch.ops import permute_benes as pb

SEED = 20261016
M32 = 0xFFFFFFFF
MAIN_T = 4096             # bits per encrypt batch on the main path
DEC_CHUNKS = MAIN_T * MAIN_T  # K3 at the product's size: 2^24 chunks, 2.68 GB at W = 40
ENC_BATCH = 1 << 22       # K4 at a large batch
PERM_CHUNKS = 1 << 20     # K8/K12 at the JAX bench's permutation size (bench.py:344)
FLEET, FLEET_T = 64, 128  # rotation fleet: 64 elements of 128 chunks, squared
REPS = 5

# wrapper -> (source, TPU kernel it replaces)
KERNELS = {
    "mul_chunks": ("csgn_tpu_torch/csrc/mul.cu", "csgn_tpu/ops/kernels.py:84"),
    "mul_decrypt": ("csgn_tpu_torch/csrc/mul.cu", "csgn_tpu/ops/kernels.py:158"),
    "decrypt_parity": ("csgn_tpu_torch/csrc/decrypt.cu", "csgn_tpu/ops/kernels.py:631"),
    "chunk_matches": ("csgn_tpu_torch/csrc/decrypt.cu", "csgn_tpu/ops/kernels.py:631"),
    "encrypt_bits_counter": ("csgn_tpu_torch/csrc/encrypt.cu",
                             "csgn_tpu/ops/encrypt_pallas.py:250"),
    "apply_benes": ("csgn_tpu_torch/csrc/benes.cu", "csgn_tpu/ops/permute_benes.py:533"),
    "apply_benes_batch": ("csgn_tpu_torch/csrc/benes.cu", "csgn_tpu/ops/permute_benes.py:399"),
    "apply_benes_decrypt": ("csgn_tpu_torch/csrc/benes.cu",
                            "csgn_tpu/ops/permute_benes.py:307"),
}
# The kernels each path must launch (LAUNCHES keys; "_batched" = the same
# kernel on [B, W, C] operands, reported in its kernel's row).
MAIN_PATH = ("mul_chunks", "mul_decrypt", "decrypt_parity", "chunk_matches",
             "encrypt_bits_counter")
ROTATION_PATH = ("apply_benes", "apply_benes_batch", "apply_benes_decrypt", "decrypt_parity",
                 "mul_chunks_batched", "mul_decrypt_batched", "decrypt_parity_batched",
                 "encrypt_bits_counter")


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
    words[..., cols] |= mask[:, None]
    return words


def canon_words(ctx: Context, shape, gen: torch.Generator, dev) -> torch.Tensor:
    """Random canonical words of `shape` [..., W, chunks], made on the card."""
    x = torch.randint(0, 1 << 32, shape, dtype=torch.int64, device=dev, generator=gen)
    valid = torch.from_numpy(ctx.valid_mask.view(np.int32)).to(dev)
    return x.to(torch.int32) & valid[:, None]


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


def check_batched(ctx, sk, gen, dev, errs: dict) -> None:
    """K1-K3 on [B, W, C] operands against their plain versions."""
    m = sk.mask_words
    w = ctx.words32
    for batch, t1, t2 in [(1, 3, 5), (7, 13, 7), (FLEET, FLEET_T, FLEET_T)]:
        a = force(canon_words(ctx, (batch, w, t1), gen, dev), slice(0, t1, 2), m)
        b = force(canon_words(ctx, (batch, w, t2), gen, dev), slice(0, t2, 3), m)
        a[1::2] = canon_words(ctx, (batch // 2, w, t1), gen, dev)  # fewer matches there
        want = kernels.mul_chunks_plain(a, b)
        e1 = max_abs_err(kernels.mul_chunks(a, b), want)
        prod, count = kernels.mul_decrypt(a, b, m, return_count=True)
        _, parity = kernels.mul_decrypt(a, b, m)
        _, want_count = kernels.mul_decrypt_plain(a, b, m, return_count=True)
        e2 = max(max_abs_err(prod, want), int((count - want_count).abs().max()),
                 int((parity - (want_count & 1)).abs().max()))
        e3 = int((kernels.decrypt_parity(want, m)
                  - kernels.decrypt_parity_plain(want, m)).abs().max())
        e4 = max_abs_err(kernels.chunk_matches(want, m), kernels.chunk_matches_plain(want, m))
        for name, e in [("mul_chunks", e1), ("mul_decrypt", e2), ("decrypt_parity", e3),
                        ("chunk_matches", e4)]:
            errs[name] = max(errs[name], e)
        require(e1 == e2 == e3 == e4 == 0, f"batched K1-K3 disagree with plain at "
                f"{batch}x({t1}x{t2})")
        require(int(count[0]) > 0, f"no forced matches counted at {batch}x({t1}x{t2})")
        print(f"[check] batched mul_chunks + mul_decrypt + decrypt_parity + chunk_matches "
              f"{batch}x({t1}x{t2}): bit-equal, counts {count[:4].tolist()}...")
        del a, b, want, prod


BENES_NS = (20, 100, 1247)
BENES_CHUNKS = (1, 129, 1025, PERM_CHUNKS)


def check_benes(gen, pgen, dev, errs: dict) -> None:
    """K8 / K12 at every (n, C), K9 at every (n, k, C), against their plain
    versions; K12 with matches forced into every 5th column."""
    saw_parity_one = False
    for n in BENES_NS:
        ctx = Context(n, min(16, n // 2))
        sk = SecretKey(ctx, torch.randperm(n, generator=pgen)[:ctx.d].numpy(), device=dev)
        p = Permutation.random(n, pgen)
        plan = p.benes_plan()
        key = sk.apply_permutation(p).mask_words   # the OUTPUT's key
        # The key's mask permuted back through p^-1 matches `key` after p.
        pre = core.permute_chunks(key[:, None], torch.tensor(p.inverse().perm), n)
        for chunks in BENES_CHUNKS:
            x = canon_words(ctx, (ctx.words32, chunks), gen, dev)
            x[:, 0:chunks:5] |= pre
            e8 = max_abs_err(benes_kernels.apply_benes(x, plan),
                             benes_kernels.apply_benes_plain(x, plan))
            out, count = benes_kernels.apply_benes_decrypt(x, plan, key, return_count=True)
            _, parity = benes_kernels.apply_benes_decrypt(x, plan, key)
            want_out, want_count = benes_kernels.apply_benes_decrypt_plain(
                x, plan, key, return_count=True)
            e12 = max(max_abs_err(out, want_out), abs(int(count) - int(want_count)),
                      abs(int(parity) - (int(want_count) & 1)))
            errs["apply_benes"] = max(errs["apply_benes"], e8)
            errs["apply_benes_decrypt"] = max(errs["apply_benes_decrypt"], e12)
            require(e8 == 0 and e12 == 0, f"K8/K12 disagree with plain at n={n} C={chunks}")
            require(int(count) >= len(range(0, chunks, 5)), f"K12 missed forced matches "
                    f"at n={n} C={chunks}")
            saw_parity_one |= int(parity) == 1
            print(f"[check] apply_benes + apply_benes_decrypt n={n} C={chunks}: bit-equal, "
                  f"count {int(count)} parity {int(parity)}")
            del x, out, want_out
        for k in (1, 3, FLEET):
            perms = [Permutation.random(n, pgen) for _ in range(k)]
            stacked = pb.stack_plans([q.benes_plan() for q in perms])
            for chunks in (1, 129, 1025) + ((1 << 14,) if k == FLEET else ()):
                x = canon_words(ctx, (k, ctx.words32, chunks), gen, dev)
                e9 = max_abs_err(benes_kernels.apply_benes_batch(x, stacked),
                                 benes_kernels.apply_benes_batch_plain(x, stacked))
                errs["apply_benes_batch"] = max(errs["apply_benes_batch"], e9)
                require(e9 == 0, f"K9 disagrees with plain at n={n} k={k} C={chunks}")
                del x
            print(f"[check] apply_benes_batch n={n} k={k}: bit-equal at C in "
                  f"{(1, 129, 1025) + ((1 << 14,) if k == FLEET else ())}")
    require(saw_parity_one, "no K12 case had parity 1")


# ---------------------------------------------------------------------------
# Phase 4: the main path at full size, through the public API
# ---------------------------------------------------------------------------


def odd_bits(rng: np.random.Generator, n: int) -> np.ndarray:
    bits = rng.integers(0, 2, n).astype(np.int32)
    if bits.sum() % 2 == 0:
        bits[0] ^= 1
    return bits


def main_path(ctx, indices, rng, dev) -> tuple[dict, Ciphertext]:
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
    idle = [k for k in MAIN_PATH if launches[k] == 0]
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
    return launches, prod


# ---------------------------------------------------------------------------
# Phase 4b: the key-rotation path at full size, through the public API
# ---------------------------------------------------------------------------


def rotation_path(ctx, indices, prod: Ciphertext, p: Permutation, perms: list, rng,
                  dev) -> dict:
    """Phase 4's 2^24-chunk product rotated by `p` and back, then a fleet of
    FLEET ciphertexts grown by `*` and rotated under `perms` (one each)."""
    fleet_bits = rng.integers(0, 2, (FLEET, FLEET_T)).astype(np.int32)
    fleet_bits[0, 0] ^= int(fleet_bits[0].sum() % 2 == 0)   # element 0 decrypts to 1,
    fleet_bits[1, 0] ^= int(fleet_bits[1].sum() % 2 == 1)   # element 1 to 0
    want = fleet_bits.sum(axis=1) % 2
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    # Single: rotate the product, read it under the rotated key, rotate back.
    sk = SecretKey(ctx, indices, device=dev)
    psk = sk.apply_permutation(p)
    rot = prod.apply_permutation(p)
    d_rot = int(psk.decrypt(rot))
    head_ok = torch.equal(rot.wt[:, :4096], core.permute_chunks(
        prod.wt[:, :4096], torch.tensor(p.perm), ctx.n))
    staged, d_staged = sk.permute_and_decrypt(prod, p)
    staged_ok = torch.equal(staged.wt, rot.wt)
    del staged
    # K12 has no API-level caller (permute_and_decrypt is staged, as in the
    # JAX package); its ops-level function is the entry point.
    fused, d_fused = benes_kernels.apply_benes_decrypt(prod.wt, p.benes_plan(), psk.mask_words)
    fused_ok, d_fused = torch.equal(fused, rot.wt), int(d_fused)
    del fused
    back_ok = torch.equal(rot.apply_permutation(p.inverse()).wt, prod.wt)
    del rot

    # Fleet: encrypt, grow with a batched `*`, decrypt, rotate, decrypt.
    batch = CiphertextBatch.stack([
        Ciphertext(sk.encrypt_batch(fleet_bits[i], SEED + 100 + i), ctx) for i in range(FLEET)
    ])
    grown = batch * batch
    dec = sk.decrypt_batch(grown).cpu().numpy()
    fused_prod, fused_bits = sk.mul_and_decrypt_batch(batch, batch)
    fused_prod_ok = torch.equal(fused_prod.wt, grown.wt)
    del fused_prod
    rotated = grown.apply_permutations(perms)
    dec_rot = np.array([int(sk.apply_permutation(perms[i]).decrypt(rotated[i]))
                        for i in range(FLEET)])
    dec_shared = psk.decrypt_batch(grown.apply_permutation(p)).cpu().numpy()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    require(d_rot == 1, f"permuted product decrypts to {d_rot} under the permuted key, not 1")
    require(head_ok, "permuted product != gather oracle on its first 4096 chunks")
    require(staged_ok and fused_ok, "permute_and_decrypt / K12 words != apply_permutation's")
    require(d_staged == d_fused == 1, f"permute_and_decrypt / K12 parity {d_staged}/{d_fused} "
            "!= 1")
    require(back_ok, "p then p.inverse() did not give the product back")
    require(tuple(grown.wt.shape) == (FLEET, ctx.words32, FLEET_T * FLEET_T), "fleet shape")
    require(np.array_equal(dec, want), "fleet decrypt_batch != expected bits")
    require(fused_prod_ok and np.array_equal(fused_bits.cpu().numpy(), want),
            "mul_and_decrypt_batch != batch * batch and expected bits")
    require(np.array_equal(dec_rot, want), "fleet decrypts under the 64 rotated keys != bits")
    require(np.array_equal(dec_shared, want), "shared-permutation fleet decrypt != bits")
    for i in (0, FLEET - 1):
        require(torch.equal(rotated.wt[i], core.permute_chunks(
            grown.wt[i], torch.tensor(perms[i].perm), ctx.n)),
            f"fleet element {i} != gather oracle under its permutation")
    idle = [k for k in ROTATION_PATH if launches[k] == 0]
    require(not idle, f"rotation path never launched: {idle}")
    print(f"[rotate] Context({ctx.n},{ctx.d}): product of {prod.chunks} chunks rotated, "
          f"decrypt under the rotated key {d_rot}, permute_and_decrypt {d_staged}, "
          f"K12 {d_fused}, rotated back bit-equal; fleet {FLEET} x {FLEET_T} chunks -> "
          f"{tuple(grown.wt.shape)} ({grown.nbytes / 1e6:.0f} MB), bits {want.tolist()[:8]}... "
          f"({int(want.sum())} ones) from decrypt_batch, mul_and_decrypt_batch, "
          f"{FLEET} rotated keys and one shared rotation; {seconds:.3f} s host wall")
    print(f"[rotate] launches {json.dumps({k: launches[k] for k in ROTATION_PATH})}; "
          f"peak device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    return launches



def profile_rotation(ctx, indices, prod: Ciphertext, p: Permutation, perms: list, dev) -> None:
    """Phase 4b three times warm (host wall), then once under torch.profiler:
    device busy time (the union of kernel intervals), idle share of the host
    wall, and the heaviest kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        rotation_path(ctx, indices, prod, p, perms, np.random.default_rng(1), dev)

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, None
    for s, e in sorted((k.time_range.start, k.time_range.end) for k in kern):
        if end is None or s > end:
            busy_us += e - s
            end = e
        elif e > end:
            busy_us += e - end
            end = e
    by_name: dict = {}
    for k in kern:
        n_us = by_name.setdefault(k.name[:60], [0, 0.0])
        n_us[0] += 1
        n_us[1] += k.time_range.end - k.time_range.start
    print(f"[profile] rotation path host wall, 3 warm runs: "
          f"{[round(w * 1e3, 3) for w in walls]} ms")
    print("[profile] " + json.dumps({
        "wall_ms_profiled": wall_ms, "device_busy_ms": busy_us / 1e3,
        "idle_share_of_wall": 1 - busy_us / 1e3 / wall_ms, "kernel_launches": len(kern)}))
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:14]:
        print(f"[profile] {us / 1e3:9.3f} ms  x{n:4d}  {name}")


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


def timings(ctx, sk, gen, dev, card: str, p: Permutation, stacked) -> dict:
    m = sk.mask_words
    w = ctx.words32
    out = {}

    def report(name, shape, nbytes, ms, plain_ms, extra="", batched=False):
        entry = {"shape": shape, "ms": ms, "plain_ms": plain_ms}
        if batched:
            out[name]["batched"] = entry
        else:
            out[name] = entry
        tag = f"{name} (batched)" if batched else name
        print(f"[time] {tag} {shape}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), "
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
    del fresh, bits, args

    # Batched K1-K3 at the fleet's shapes: 64 x (128 x 128), real ciphertexts.
    def fleet(seed):
        bits = torch.randint(0, 2, (FLEET * FLEET_T,), dtype=torch.int32, device=dev,
                             generator=gen)
        words = sk.encrypt_batch(bits, seed)            # [W, FLEET * FLEET_T]
        return words.reshape(w, FLEET, FLEET_T).permute(1, 0, 2).contiguous()

    fab = [(fleet(SEED + 50 + 2 * k), fleet(SEED + 51 + 2 * k)) for k in range(REPS)]
    fshape = f"{FLEET}x({FLEET_T}x{FLEET_T})"
    fbytes = FLEET * w * FLEET_T * FLEET_T * 4
    ms, pms = time_pair(kernels.mul_chunks, kernels.mul_chunks_plain, fab)
    report("mul_chunks", fshape, fbytes, ms, pms, batched=True)
    ms, pms = time_pair(lambda x, y: kernels.mul_decrypt(x, y, m),
                        lambda x, y: kernels.mul_decrypt_plain(x, y, m), fab)
    report("mul_decrypt", fshape, fbytes, ms, pms, batched=True)
    fprods = [(kernels.mul_chunks(x, y),) for x, y in fab]
    del fab
    ms, pms = time_pair(lambda x: kernels.decrypt_parity(x, m),
                        lambda x: kernels.decrypt_parity_plain(x, m), fprods)
    report("decrypt_parity", f"{FLEET}x{w}x{FLEET_T * FLEET_T}", fbytes, ms, pms,
           " (bytes counted over all W rows)", batched=True)
    del fprods

    # Beneš kernels at n = 1247: K8 / K12 over 2^20 chunks, K9 over 64 x 2^14.
    # Bytes are the payload read plus written (K12: read only is the floor).
    plan = p.benes_plan()
    key = sk.apply_permutation(p).mask_words
    xs = [(canon_words(ctx, (w, PERM_CHUNKS), gen, dev),) for _ in range(REPS)]
    pbytes = 2 * w * PERM_CHUNKS * 4
    ms, pms = time_pair(lambda x: benes_kernels.apply_benes(x, plan),
                        lambda x: benes_kernels.apply_benes_plain(x, plan), xs)
    report("apply_benes", f"{w}x{PERM_CHUNKS}", pbytes, ms, pms,
           f", {PERM_CHUNKS / ms / 1e3:.1f} M chunks/s")
    ms, pms = time_pair(lambda x: benes_kernels.apply_benes_decrypt(x, plan, key),
                        lambda x: benes_kernels.apply_benes_decrypt_plain(x, plan, key), xs)
    fused_ms, staged_ms = time_pair(
        lambda x: benes_kernels.apply_benes_decrypt(x, plan, key),
        lambda x: kernels.decrypt_parity(benes_kernels.apply_benes(x, plan), key), xs)
    report("apply_benes_decrypt", f"{w}x{PERM_CHUNKS}", pbytes, ms, pms,
           f"; staged K8 + K3 {staged_ms:.4f} ms against fused {fused_ms:.4f} ms in turns")
    out["apply_benes_decrypt"]["staged_ms"] = staged_ms
    del xs
    kc = 1 << 14
    xb = [(canon_words(ctx, (stacked.k, w, kc), gen, dev),) for _ in range(REPS)]
    ms, pms = time_pair(lambda x: benes_kernels.apply_benes_batch(x, stacked),
                        lambda x: benes_kernels.apply_benes_batch_plain(x, stacked), xb)
    report("apply_benes_batch", f"{stacked.k}x{w}x{kc}", 2 * stacked.k * w * kc * 4, ms, pms,
           f", {stacked.k * kc / ms / 1e3:.1f} M chunks/s")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile phase 4b (the key-rotation path)")
    args = parser.parse_args()
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

    pgen = torch.Generator().manual_seed(SEED)  # permutations are drawn on the host

    # Phase 3: kernels vs plain.
    errs = dict.fromkeys(KERNELS, 0)
    check_kernels(ctx, sk, gen, dev, errs)
    check_batched(ctx, sk, gen, dev, errs)
    check_benes(gen, pgen, dev, errs)
    torch.cuda.synchronize()

    # Phase 4: the main path.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    main_launches, prod = main_path(ctx, indices, rng, dev)
    torch.cuda.empty_cache()

    # Phase 4b: the key-rotation path.  Host routing of the plans is set-up.
    p = Permutation.random(ctx, pgen)
    perms = [Permutation.random(ctx, pgen) for _ in range(FLEET)]
    t0 = time.perf_counter()
    stacked = pb.stack_plans([q.benes_plan() for q in perms])
    p.benes_plan()
    print(f"[rotate] {FLEET + 1} Beneš plans routed on the host in "
          f"{time.perf_counter() - t0:.2f} s (cached on each Permutation)")
    torch.cuda.reset_peak_memory_stats(dev)
    rot_launches = rotation_path(ctx, indices, prod, p, perms, rng, dev)
    if args.profile:
        profile_rotation(ctx, indices, prod, p, perms, dev)
    del prod
    torch.cuda.empty_cache()

    # Phase 5: timings.
    times = timings(ctx, sk, gen, dev, smi, p, stacked)
    torch.cuda.synchronize()

    rows = []
    for name, (src, rep) in KERNELS.items():
        by_path = {path: launches.get(name, 0) + launches.get(name + "_batched", 0)
                   for path, launches in (("main", main_launches), ("rotation", rot_launches))}
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": errs[name], **times[name],
        })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
