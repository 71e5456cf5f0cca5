"""Serving-executor demo: correctness and launch amortization.

The port of the JAX package's tools/serve_demo.py, at its sizes: Context(1247,
16), 32 requests, with its keys (``rng.key(11)`` split 256 ways for the key
and the operands, ``rng.key(77)``, ``78`` and ``100 + trial`` for the
executors), so every ciphertext is the JAX demo's.  First it asserts that one `BatchExecutor` flush of 32
encrypts, 32 fused multiply+decrypts and 8 permutations gives the same
bits and words as the unbatched calls.  Then it times 32 independent fused
multiply+decrypt requests (two-chunk operands) two ways, for three
trials: a loop of `SecretKey.mul_and_decrypt`, one launch and one host
round trip per request (the reference's one-op-per-call pattern,
tests/timings.cpp:26-42), and one executor flush, one batched launch for
all of them.  Both must give equal bits; it prints both host wall times
(synchronized) and the speedup.

Run: python -m csgn_tpu_torch.tools.serve_demo [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from csgn_tpu_torch import BatchExecutor, Context, Permutation, SecretKey, rng
from csgn_tpu_torch._device import resolve_device

REQUESTS, TRIALS, SEED = 32, 3, 11


def main(device=None) -> dict:
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})")
    ctx = Context(1247, 16)
    keys = rng.split(rng.key(SEED), 256)
    sk = SecretKey.generate(ctx, keys[0], dev)

    bits_a = [1] * REQUESTS
    bits_b = [i % 2 for i in range(REQUESTS)]
    a = [sk.encrypt(v, keys[2 + i]) for i, v in enumerate(bits_a)]
    b = [sk.encrypt(v, keys[64 + i]) for i, v in enumerate(bits_b)]
    # grow operands so requests are not the trivial 1x1 AND
    ga = [x + y for x, y in zip(a, b)]          # 2 chunks, parity 1^bit
    gb = [y + x for x, y in zip(a, b)]

    # --- correctness: executor vs unbatched ---
    ex = BatchExecutor(sk, rng=rng.key(77))
    enc_f = [ex.submit_encrypt(v) for v in bits_b]
    md_f = [ex.submit_mul_decrypt(x, y) for x, y in zip(ga, gb)]
    draws = np.random.default_rng(1)
    perms = [Permutation(draws.permutation(ctx.n).astype(np.int32)) for _ in range(8)]
    pm_f = [ex.submit_permute(a[i], perms[i]) for i in range(8)]
    ex.flush()
    got_enc = [int(sk.decrypt(f.result())) for f in enc_f]
    if got_enc != bits_b:
        raise RuntimeError(f"batched encrypts decrypt to {got_enc}, not {bits_b}")
    for x, y, f in zip(ga, gb, md_f):
        prod, bit = f.result()
        want = int(sk.decrypt(x * y))
        if bit != want or int(sk.decrypt(prod)) != want:
            raise RuntimeError("a batched mul_decrypt differs from the unbatched product")
    for i, f in enumerate(pm_f):
        if not torch.equal(f.result().wt, a[i].apply_permutation(perms[i]).wt):
            raise RuntimeError(f"batched permutation {i} differs from the unbatched one")
    print("correctness: enc/mul_decrypt/permute batched == unbatched OK")
    print("group dispatches for", ex.stats["requests"], "requests:",
          ex.stats["group_dispatches"])

    # --- latency: per-request launches vs one batched flush ---
    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def per_request():
        return [int(sk.mul_and_decrypt(x, y)[1]) for x, y in zip(ga, gb)]

    def batched(k):
        ex3 = BatchExecutor(sk, rng=rng.key(100 + k))
        fs = [ex3.submit_mul_decrypt(x, y) for x, y in zip(ga, gb)]
        ex3.flush()
        return [f.result()[1] for f in fs]

    per_request()                   # warm both paths, as the JAX demo does
    ex2 = BatchExecutor(sk, rng=rng.key(78))
    [ex2.submit_mul_decrypt(x, y) for x, y in zip(ga[:2], gb[:2])]
    ex2.flush()
    rows = []
    for trial in range(TRIALS):
        seq_bits, t_seq = timed(per_request)
        bat_bits, t_bat = timed(lambda: batched(trial))
        if seq_bits != bat_bits:
            raise RuntimeError(f"trial {trial}: per-request bits {seq_bits} != batched "
                               f"{bat_bits}")
        rows.append({"per_request_ms": t_seq * 1e3, "batched_ms": t_bat * 1e3,
                     "speedup": t_seq / t_bat})
        print(f"trial {trial}: {REQUESTS} mul_decrypt requests  per-request "
              f"{t_seq * 1e3:7.3f} ms  batched {t_bat * 1e3:7.3f} ms  speedup "
              f"{t_seq / t_bat:5.2f}x")
    print("VERIFY SERVE: ALL OK")
    return {"requests": REQUESTS, "device": name, "bits": bat_bits, "trials": rows}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA "
                                                   "device)")
    args = ap.parse_args()
    main(args.device)
