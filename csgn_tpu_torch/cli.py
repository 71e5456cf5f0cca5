"""Command-line entry point: ``python -m csgn_tpu_torch.cli <command>``.

The JAX package's CLI (`csgn_tpu.cli`) on the port, with the same commands
and options plus ``--device`` (default: the current CUDA device; ``cpu``
runs the plain torch versions):

  demo      — the reference's basic_operations + permutations scenarios,
              asserted (reference tests/basic_operations.cpp, permutations.cpp)
  selftest  — batched encrypt/decrypt round trip of ``batch`` bits
  timings   — microbenchmark table mirroring reference tests/timings.cpp,
              plus the multiply's write anchor
  info      — context, layout and device report
  flagship  — homomorphic AES-128 (FIPS-197) + SHA-256 (hashlib), asserted

Randomness comes from ``seed`` as in the JAX CLI: each command splits
``rng.key(seed)`` (``jax.random.key(seed)``) into the same keys and uses
them in the same places, on the default encrypt engine, so its secret keys,
ciphertext words and permutations are the JAX CLI's.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import struct
import sys
import time

import numpy as np
import torch

from csgn_tpu_torch import rng
from csgn_tpu_torch._device import resolve_device
from csgn_tpu_torch.config import RunConfig
from csgn_tpu_torch.utils.metrics import op_metrics

__all__ = ["main"]


def _load_config(args) -> RunConfig:
    if args.config:
        with open(args.config) as f:
            return RunConfig.from_json(f.read())
    return RunConfig(n=args.n, d=args.d, seed=args.seed)


def _keys(cfg: RunConfig, k: int) -> tuple[rng.Key, ...]:
    """``jax.random.split(jax.random.key(seed), k)``, as the JAX CLI draws."""
    return rng.split(rng.key(cfg.seed), k)


def cmd_demo(cfg: RunConfig, dev: torch.device) -> int:
    from csgn_tpu_torch import Permutation, Plaintext, SecretKey

    ctx = cfg.context()
    keys = _keys(cfg, 4)
    print(f"Context: n={ctx.n} d={ctx.d} s={ctx.s} words/chunk={ctx.words64}")

    sk = SecretKey.generate(ctx, keys[0], dev)
    c1 = sk.encrypt(Plaintext(1), keys[1])
    c0 = sk.encrypt(Plaintext(0), keys[2])
    added, multiplied = c1 + c0, c1 * c0
    da, dm = sk.decrypt(added), sk.decrypt(multiplied)
    print(f"Dec ( Enc (1) + Enc (0) ) = {da}")
    print(f"Dec ( Enc (1) * Enc (0) ) = {dm}")
    assert int(da) == 1 and int(dm) == 0

    perm = Permutation.random(ctx, keys[3])
    psk = sk.apply_permutation(perm)
    pct = c1.apply_permutation(perm)
    dp = psk.decrypt(pct)
    print(f"Dec_perm ( Perm ( Enc (1) ) ) = {dp}")
    assert int(dp) == 1
    assert (perm + perm.inverse()).is_identity()
    print("demo OK")
    return 0


def cmd_selftest(cfg: RunConfig, dev: torch.device) -> int:
    from csgn_tpu_torch import SecretKey

    ctx = cfg.context()
    keys = _keys(cfg, 3)
    sk = SecretKey.generate(ctx, keys[0], dev)
    bits = np.random.default_rng(cfg.seed).integers(0, 2, cfg.batch).astype(np.int32)
    words = sk.encrypt_batch(bits, keys[1])
    dec = sk.decrypt_batch(words).cpu().numpy()
    ok = bool(np.array_equal(dec, bits))
    print(f"batched encrypt/decrypt roundtrip x{cfg.batch}: {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


def cmd_timings(cfg: RunConfig, dev: torch.device) -> int:
    """Eight rows, mapping 1:1 onto reference tests/timings.cpp: keygen,
    encrypt, fresh add, fresh multiply, permutation generation, permute
    secret key, permute ciphertext, decrypt (permuted key + ciphertext) —
    plus the reference's size lines.  The device rows time the port's public
    dispatch (on a CUDA device: the kernels) with `device_median_time`.  After
    the multiply, the write anchor (K5, a fill of the product's bytes at the
    card's write floor) and anchor ms / multiply ms, the JAX bench's
    ``value_vs_anchor``: the multiply's share of the write floor."""
    from csgn_tpu_torch import Ciphertext, Permutation, SecretKey
    from csgn_tpu_torch.ops import core, dispatch, kernels
    from csgn_tpu_torch.utils.timing import Timer, device_median_time

    ctx = cfg.context()
    keys = _keys(cfg, 4)
    print(f"[device rows: median of 7 on {dev}"
          f"{', CUDA events' if dev.type == 'cuda' else ', host clock'}]")

    SecretKey.generate(ctx, keys[3], dev)      # warm the key's device copies
    t = Timer("keygen")
    t.start()
    sk = SecretKey.generate(ctx, keys[0], dev)
    t.stop_and_print()

    bits = torch.as_tensor(np.random.default_rng(0).integers(0, 2, cfg.batch), device=dev)
    te = device_median_time(lambda: sk.encrypt_batch(bits, keys[1]), device=dev)
    print(f"encrypt x{cfg.batch}: {te*1e3:.3f} ms ({cfg.batch/te:,.0f} enc/s)")

    words = sk.encrypt_batch(bits, keys[1])
    # Fresh addition (reference timings.cpp:34-37): chunk concatenation.
    ta = device_median_time(lambda: core.add_chunks(words, words), device=dev)
    print(f"add {cfg.batch}+{cfg.batch} chunks: {ta*1e3:.3f} ms")

    tm = device_median_time(lambda: dispatch.mul_chunks(words, words), device=dev)
    print(f"multiply {cfg.batch}x{cfg.batch} chunks: {tm*1e3:.3f} ms")
    tf = device_median_time(
        lambda: kernels.fill_anchor(cfg.seed, cfg.batch, cfg.batch, ctx.words32, dev), device=dev)
    print(f"write anchor {cfg.batch}x{cfg.batch} chunks: {tf*1e3:.3f} ms "
          f"(anchor / multiply = {tf / tm:.3f})")

    Permutation.random(ctx, keys[3])
    tp = Timer("permutation generation")
    tp.start()
    perm = Permutation.random(ctx, keys[2])
    tp.stop_and_print()

    tk = Timer("permute secret key")
    tk.start()
    psk = sk.apply_permutation(perm)
    tk.stop_and_print()

    # Permute the ciphertext (reference timings.cpp:56-60): Beneš plan over
    # the whole batch of chunks (the plan is routed on the host, once, here).
    plan = perm.benes_plan()
    tc = device_median_time(lambda: dispatch.permute(words, plan), device=dev)
    print(f"permute ciphertext ({cfg.batch} chunks): {tc*1e3:.3f} ms")

    # Decrypt with the permuted key over the permuted ciphertext
    # (reference timings.cpp:62-66).
    pwords = dispatch.permute(words, plan)
    td = device_median_time(lambda: dispatch.decrypt_parity(pwords, psk.mask_words),
                            device=dev)
    print(f"decrypt {cfg.batch} chunks (permuted key): {td*1e3:.3f} ms")

    # Size lines (reference timings.cpp:69-72).
    c1 = Ciphertext(words[:, :1], ctx)
    print(f"\nSecret key size: {sk.size()} bytes")
    print(f"Fresh ciphertext size: {c1.size()} bytes")
    print(f"After multiplication ciphertext size: {(c1 * c1).size()} bytes")
    print(f"After addition ciphertext size: {(c1 + c1).size()} bytes")

    print("\nper-op metrics (host time per op):")
    print(op_metrics().format_table())
    return 0


def cmd_flagship(cfg: RunConfig, dev: torch.device) -> int:
    """Homomorphic AES-128 (FIPS-197 C.1) + SHA-256 (vs hashlib) end to end:
    encrypt every input bit, evaluate the whole circuit as a growth-free expr
    DAG, decrypt key-side, assert the known answers."""
    from csgn_tpu_torch import Ciphertext, SecretKey
    from csgn_tpu_torch.models.aes import aes128
    from csgn_tpu_torch.models.netlist import bits_from_bytes, bytes_from_bits, eval_expr
    from csgn_tpu_torch.models.sha256 import SHA256_IV, sha256_compress, sha256_pad_one_block

    ctx = cfg.context()
    keys = _keys(cfg, 4)
    sk = SecretKey.generate(ctx, keys[0], dev)
    one = sk.encrypt(1, keys[1])

    def enc_bits(bits, key):
        words = sk.encrypt_batch(np.array(bits, dtype=np.int32), key)
        return [Ciphertext(words[:, i:i + 1], ctx) for i in range(len(bits))]

    aes_key = bytes(range(16))
    block = bytes.fromhex("00112233445566778899aabbccddeeff")
    t0 = time.time()
    cts = enc_bits(bits_from_bytes(aes_key + block), keys[2])
    (outs,) = eval_expr(aes128(), [cts[:128], cts[128:]], one)
    got = bytes_from_bits([int(v) for v in sk.decrypt_circuits(outs)])
    print(f"AES-128(FIPS C.1) homomorphically = {got.hex()}  [{time.time()-t0:.1f}s]")
    assert got.hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"

    msg = b"csgn_tpu flagship"
    iv = b"".join(struct.pack(">I", h) for h in SHA256_IV)
    t0 = time.time()
    cts = enc_bits(bits_from_bytes(sha256_pad_one_block(msg) + iv), keys[3])
    (outs,) = eval_expr(sha256_compress(), [cts[:512], cts[512:]], one)
    got = bytes_from_bits([int(v) for v in sk.decrypt_circuits(outs)])
    print(f"SHA-256({msg!r}) homomorphically = {got.hex()}  [{time.time()-t0:.1f}s]")
    assert got == hashlib.sha256(msg).digest()
    print("flagship OK")
    return 0


def cmd_info(cfg: RunConfig, dev: torch.device) -> int:
    ctx = cfg.context()
    print(f"csgn_tpu_torch context: n={ctx.n} d={ctx.d} s={ctx.s}")
    print(f"layout: words64={ctx.words64} words32={ctx.words32} "
          f"bitlen={ctx.bitlen[:3]}...{ctx.bitlen[-1]}")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"torch {torch.__version__}; device: {dev} ({name})")
    print(f"cuda devices: {torch.cuda.device_count()}")
    return 0


COMMANDS = {
    "demo": cmd_demo,
    "selftest": cmd_selftest,
    "timings": cmd_timings,
    "info": cmd_info,
    "flagship": cmd_flagship,
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="csgn_tpu_torch", description=__doc__)
    p.add_argument("command", choices=list(COMMANDS))
    p.add_argument("--n", type=int, default=1247)
    p.add_argument("--d", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--config", type=str, default=None, help="JSON RunConfig path")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the current CUDA device; cpu runs the "
                        "plain torch versions)")
    p.add_argument(
        "--metrics", action="store_true",
        help="print the per-op table after the command: calls, chunks, MB and host time per op",
    )
    args = p.parse_args(argv)
    cfg = _load_config(args)
    # The table's ms are the ops' spans, recorded for this command only.
    table = args.metrics or args.command == "timings"
    with op_metrics().recording() if table else contextlib.nullcontext():
        rc = COMMANDS[args.command](cfg, resolve_device(args.device))
    if args.metrics:
        print("\nper-op metrics (host time per op):")
        print(op_metrics().format_table())
    return rc


if __name__ == "__main__":
    sys.exit(main())
