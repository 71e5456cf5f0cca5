"""Kernel-against-plain validation sweep, the port of the JAX package's
tools/tpu_validate.py.

It runs that sweep's shape classes through the port's public wrappers on one
device and holds every result to the plain torch version on the same device
(exact equality): on the card the CUDA kernels against their plain versions,
on the CPU (``--device cpu``, where the wrappers run the plain versions) the
control flow and the oracles.  Where the JAX sweep prints a TPU route, this
one prints the multiply's mode (`kernels.mul_mode`) and the kernel launches
the case made (`kernels.LAUNCHES`; "plain" on the CPU).  Cases:

  * the product (K1 aligned, or the unaligned mode) at (1,128) ... (3,4096);
  * decrypt (K3) at 1 ... 100,000 chunks;
  * the Beneš permute (K8) at 1 ... 131,072 chunks, against the gather oracle;
  * the fused product (K2) at (5,4096), (64,131072) and (3,384), with the
    key's mask forced into chosen columns so the parities are not all 0;
  * ``*`` at (37,1000), (100000,3), (7,70000), (513,129), and
    `SecretKey.mul_and_decrypt` at the seven shapes of the JAX sweep's
    fused-envelope case, then chained: a 60,000-chunk product times two
    chunks;
  * the batched permute with four plans (K9), per element against the gather;
  * the Philox encrypt (K7) and the default engine's (K14): words equal to
    the plain version, canonical, decrypting to the bits;
  * end to end: 2^20 bits encrypted under ``rng.key(2)`` (K14), multiplied
    by a two-chunk ciphertext encrypted under ``rng.key(3)``, both
    decrypted, with the time taken.

The secret key is the JAX sweep's, drawn from ``rng.key(1)``.

``--small`` cuts every shape class to sizes the CPU runs in seconds.

Run: python -m csgn_tpu_torch.tools.validate [--small] [--device cpu]
It prints one line a case and ``FAILS: none`` and exits 0 only when every
case matches.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from csgn_tpu_torch import Ciphertext, Context, Permutation, SecretKey, rng
from csgn_tpu_torch._device import resolve_device
from csgn_tpu_torch.layout import words_from_numpy
from csgn_tpu_torch.ops import core, dispatch, kernels
from csgn_tpu_torch.ops import encrypt_kernels as ek
from csgn_tpu_torch.ops import permute_benes as pb

# The JAX sweep's shapes (tools/tpu_validate.py:40-192), and a cut of each
# class for the CPU.
FULL = {
    "mul": [(1, 128), (4, 128), (37, 256), (128, 1024), (4096, 512), (3, 4096)],
    "dec": [1, 127, 4096, 100000],
    "perm": [1, 100, 8192, 131072],
    "fused": [(5, 4096), (64, 131072), (3, 384)],
    "auto": [(37, 1000), (100000, 3), (7, 70000), (513, 129)],
    "fused_auto": [(4096, 5), (131072, 3), (7, 70000), (100000, 3), (1000, 20), (513, 129),
                   (37, 63)],
    "chained": (20000, 3, 2),
    "kperm": (4, 4096),
    "encrypt": 4096,
    "e2e": 1 << 20,
}
SMALL = {
    "mul": [(1, 128), (4, 128), (37, 256), (3, 4096)],
    "dec": [1, 127, 4096],
    "perm": [1, 100, 1025],
    "fused": [(5, 4096), (8, 1024), (3, 384)],
    "auto": [(37, 100), (1000, 3), (7, 700), (51, 129)],
    "fused_auto": [(4096, 5), (1311, 3), (7, 700), (1000, 3), (100, 20), (51, 129), (37, 63)],
    "chained": (200, 3, 2),
    "kperm": (4, 129),
    "encrypt": 4096,
    "e2e": 1 << 14,
}


class Sweep:
    """One run of the sweep: the context, the key, the inputs' generator and
    the failures so far."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.ctx = Context(1247, 16)
        self.rng = np.random.default_rng(0)
        self.sk = SecretKey.generate(self.ctx, rng.key(1), dev)
        self.mask = self.sk.mask_words
        self.fails: list = []

    def words(self, chunks: int, forced: int = 0) -> torch.Tensor:
        """Random canonical words [W, chunks] on the device, with the key's
        mask ORed into `forced` random columns."""
        w = self.rng.integers(0, 2**32, (self.ctx.words32, chunks), dtype=np.uint32)
        w &= self.ctx.valid_mask[:, None]
        if forced:
            w[:, self.rng.choice(chunks, min(forced, chunks), replace=False)] |= \
                self.sk.mask[:, None]
        return words_from_numpy(w, self.dev)

    def report(self, label: str, ok: bool, before: dict, extra: str = "") -> None:
        launched = ",".join(f"{k}+{v - before[k]}" for k, v in kernels.LAUNCHES.items()
                            if v > before[k]) or "plain"
        print(f"{label} [{launched}]: exact={ok}{extra}")
        if not ok:
            self.fails.append(label)

    def mode(self, t1: int, t2: int) -> str:
        return kernels.mul_mode(self.ctx.words32, t1, t2, True)

    # -- cases -------------------------------------------------------------

    def mul(self, shapes) -> None:
        for t1, t2 in shapes:
            a, b = self.words(t1), self.words(t2)
            before = dict(kernels.LAUNCHES)
            got = kernels.mul_chunks(a, b)
            ok = torch.equal(got, kernels.mul_chunks_plain(a, b))
            self.report(f"mul {t1}x{t2} mode={self.mode(t1, t2)}", ok, before)

    def dec(self, sizes) -> None:
        for chunks in sizes:
            w = self.words(chunks, forced=3)
            before = dict(kernels.LAUNCHES)
            got = int(kernels.decrypt_parity(w, self.mask))
            ok = got == int(kernels.decrypt_parity_plain(w, self.mask))
            self.report(f"dec chunks={chunks}", ok, before, f" parity={got}")

    def perm(self, sizes) -> None:
        perm = self.rng.permutation(self.ctx.n).astype(np.int32)
        plan = pb.build_plan(perm, self.ctx.n)
        for chunks in sizes:
            w = self.words(chunks)
            before = dict(kernels.LAUNCHES)
            got = dispatch.permute(w, plan)
            ok = torch.equal(got, core.permute_chunks(w, torch.from_numpy(perm), self.ctx.n))
            self.report(f"permute chunks={chunks}", ok, before)

    def fused(self, shapes) -> None:
        for t1, t2 in shapes:
            a, b = self.words(t1, forced=3), self.words(t2, forced=5)
            before = dict(kernels.LAUNCHES)
            prod, par = dispatch.mul_decrypt(a, b, self.mask)
            want = kernels.mul_chunks_plain(a, b)
            ok = torch.equal(prod, want) and int(par) == int(
                kernels.decrypt_parity_plain(want, self.mask))
            self.report(f"mul_decrypt {t1}x{t2} mode={self.mode(t1, t2)}", ok, before,
                        f" parity={int(par)}")

    def auto(self, shapes) -> None:
        ctx = self.ctx
        for t1, t2 in shapes:
            a, b = self.words(t1), self.words(t2)
            before = dict(kernels.LAUNCHES)
            got = (Ciphertext(a, ctx) * Ciphertext(b, ctx)).canonical().wt
            ok = torch.equal(got, kernels.mul_chunks_plain(a, b))
            self.report(f"mul auto {t1}x{t2} mode={self.mode(t1, t2)}", ok, before)

    def _mul_and_decrypt(self, label: str, ca: Ciphertext, cb: Ciphertext) -> None:
        before = dict(kernels.LAUNCHES)
        prod, par = self.sk.mul_and_decrypt(ca, cb)
        want = kernels.mul_chunks_plain(ca.canonical().wt, cb.canonical().wt)
        ok = torch.equal(prod.canonical().wt, want) and int(par) == int(
            kernels.decrypt_parity_plain(want, self.mask))
        self.report(f"{label} mode={self.mode(ca.chunks, cb.chunks)}", ok, before,
                    f" parity={int(par)}")

    def fused_auto(self, shapes) -> None:
        for t1, t2 in shapes:
            ca = Ciphertext(self.words(t1, forced=3), self.ctx)
            cb = Ciphertext(self.words(t2, forced=5), self.ctx)
            self._mul_and_decrypt(f"mul_and_decrypt auto {t1}x{t2}", ca, cb)

    def chained(self, t1: int, t2: int, t3: int) -> None:
        """A product accumulator (the real chain's shape) into the fused
        multiply: t1 x t2 chunks, then times t3."""
        accs = Ciphertext(self.words(t1), self.ctx) * Ciphertext(self.words(t2), self.ctx)
        tiny = Ciphertext(self.words(t3, forced=1), self.ctx)
        self._mul_and_decrypt(f"mul_and_decrypt chained {accs.chunks}x{t3}", accs, tiny)

    def kperm(self, k: int, chunks: int) -> None:
        ctx = self.ctx
        perms = [Permutation(self.rng.permutation(ctx.n).astype(np.int32)) for _ in range(k)]
        stacked = pb.stack_plans([p.benes_plan() for p in perms])
        words = torch.stack([self.words(chunks) for _ in range(k)])
        before = dict(kernels.LAUNCHES)
        got = dispatch.permute_batched_multi(words, stacked)
        ok = all(torch.equal(got[i], core.permute_chunks(words[i], torch.tensor(p.perm), ctx.n))
                 for i, p in enumerate(perms))
        self.report(f"batched multi-perm k={k} chunks={chunks}", ok, before)

    def encrypt(self, batch: int) -> None:
        """The Philox engine (seed 1234) and the default engine (key 1234)
        against their plain versions, round trip and canonical form."""
        bits = torch.from_numpy(self.rng.integers(0, 2, batch).astype(np.int32)).to(self.dev)
        ops = self.sk.encrypt_operands
        for name, fn, plain, r in (
                ("philox", ek.encrypt_bits_philox, ek.encrypt_bits_philox_plain, 1234),
                ("threefry", ek.encrypt_bits_threefry, ek.encrypt_bits_threefry_plain,
                 rng.key(1234))):
            before = dict(kernels.LAUNCHES)
            words = fn(r, bits, *ops)
            ok = (torch.equal(words, plain(r, bits, *ops))
                  and torch.equal(self.sk.decrypt_batch(words), bits)
                  and not bool((words & ~ops[2][:, None]).any()))
            self.report(f"{name} encrypt {batch} round trip+canonical", ok, before)

    def e2e(self, batch: int) -> float:
        """`batch` bits encrypted, times a [1, 0] ciphertext, both decrypted;
        returns the seconds taken, synchronized."""
        ctx, sk = self.ctx, self.sk
        big_bits = self.rng.integers(0, 2, batch).astype(np.int32)
        sync = torch.cuda.synchronize if self.dev.type == "cuda" else (lambda: None)
        before = dict(kernels.LAUNCHES)
        sync()
        t0 = time.perf_counter()
        big = Ciphertext(sk.encrypt_batch(big_bits, rng.key(2)), ctx)
        op = Ciphertext(sk.encrypt_batch(np.array([1, 0], np.int32), rng.key(3)), ctx)
        prod = big * op
        d_big, d_op, d_prod = int(sk.decrypt(big)), int(sk.decrypt(op)), int(sk.decrypt(prod))
        sync()
        seconds = time.perf_counter() - t0
        expect = int(big_bits.sum() % 2)
        ok = d_big == expect and d_prod == (expect & d_op) and d_op == 1
        self.report(f"e2e {batch}-chunk multiply+decrypt", ok, before,
                    f" ({seconds:.3f} s, parity {d_prod})")
        return seconds


def main(small: bool = False, device=None) -> int:
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={dev} ({name}) shapes={'small' if small else 'full'}", file=sys.stderr)
    shapes = SMALL if small else FULL
    s = Sweep(dev)
    s.mul(shapes["mul"])
    s.dec(shapes["dec"])
    s.perm(shapes["perm"])
    s.fused(shapes["fused"])
    s.auto(shapes["auto"])
    s.fused_auto(shapes["fused_auto"])
    s.chained(*shapes["chained"])
    s.kperm(*shapes["kperm"])
    s.encrypt(shapes["encrypt"])
    s.e2e(shapes["e2e"])
    print("FAILS:", s.fails or "none")
    return 1 if s.fails else 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true", help="the CPU's cut of every shape class")
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA "
                                                   "device)")
    args = ap.parse_args()
    sys.exit(main(args.small, args.device))
