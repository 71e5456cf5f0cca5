"""Fleets of AES-128 requests, evaluated under encryption and read out by the
key holder: `BatchExecutor.submit_netlist_expr` over the program's
`models.aes.aes128()` netlist, then ``flush()`` and every request's bits.

Each request is one block under its own key: its 256 input wires (the key's
128 bits, then the block's) are fresh single-chunk ciphertexts, which the
benchmark makes as the client's upload.  The mix's ``shapes`` hold the
fleet size and ``sets`` the distinct fleets of the pool; the client makes
the `Ciphertext` wrappers as it submits, as a client hands its upload over.
A fleet counts its requests as blocks.

The check compares every output bit of every request with AES-128 of the
same key and block (the reference, FIPS-197); a request that never resolved
is missing.  The control puts the reference with one round fewer in the
program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.inputs import device_generator, fresh_chunks, host_rng
from portbench.reference import aes128

HALF = 128  # wires of the key, then of the block


class Op:
    unit = "blocks"

    def __init__(self, env):
        self.env = env
        (self.fleet,) = env.traffic["shapes"][0]
        self.sets = env.traffic["sets"]

    def setup(self) -> None:
        env = self.env
        with env.stage("program import"):
            from csgn_tpu_torch import BatchExecutor, Ciphertext, Context, SecretKey
            from csgn_tpu_torch.models.aes import aes128 as netlist
        self._ct = Ciphertext
        n, d = env.config["n"], env.config["d"]
        rng = host_rng(env.seed, "aes-blocks")
        self.keys = rng.integers(0, 256, (self.sets, self.fleet, 16), dtype=np.uint8)
        self.blocks = rng.integers(0, 256, (self.sets, self.fleet, 16), dtype=np.uint8)
        with env.stage("inputs"):
            bits = np.concatenate([aes128.to_bits(self.keys), aes128.to_bits(self.blocks)], -1)
            gen = device_generator(env.seed, "aes-upload", env.device)
            # [sets, fleet, 256 wires, W, 1]: each wire a contiguous [W, 1] chunk
            self.pool = fresh_chunks(torch.from_numpy(bits).to(env.device), env.positions, n,
                                     gen)[..., None]
            if env.device.type == "cuda":
                torch.cuda.synchronize(env.device)
        with env.stage("netlist"):
            self.netlist = netlist()
        with env.stage("program set-up"):
            self.ctx = Context(n, d)
            self.sk = SecretKey(self.ctx, env.positions, env.device)
            self.ex = BatchExecutor(self.sk)
        self.log: list[tuple[int, list]] = []

    def _fleet(self, f: int) -> list:
        """One fleet through the program: the outputs (or exceptions) of its
        requests."""
        span = self.env.tracer.span
        if self.env.control:
            out = aes128.encrypt(self.keys[f], self.blocks[f], rounds=9)
            return [[list(map(int, row))] for row in aes128.to_bits(out)]
        with span("serve.submit", sync=False):
            futs = []
            for wires in self.pool[f]:
                cts = [self._ct(w, self.ctx) for w in wires.unbind(0)]
                futs.append(self.ex.submit_netlist_expr(self.netlist, (cts[:HALF], cts[HALF:])))
        outs = []
        with span("serve.flush", sync=True):
            self.ex.flush()
            for fut in futs:
                try:
                    outs.append(fut.result())
                except Exception as exc:  # noqa: BLE001 - a failed request is missing
                    outs.append(exc)
        return outs

    def warm(self) -> None:
        self._fleet(0)

    def run(self, item, k: int):
        outs = self._fleet(item[1])
        self.log.append((item[1], outs))
        bad = sum(isinstance(o, Exception) for o in outs)
        return self.fleet, 0, self.fleet, bad

    def check(self) -> dict:
        self.ex = self.sk = None
        want = aes128.to_bits(aes128.encrypt(self.keys.reshape(-1, 16),
                                             self.blocks.reshape(-1, 16)))
        want = want.reshape(self.sets, self.fleet, -1)
        missing = wrong = 0
        for f, outs in self.log:
            for r, out in enumerate(outs):
                if isinstance(out, Exception):
                    missing += 1
                    continue
                got = np.asarray(out, dtype=np.int64).reshape(-1)
                wrong += int((got != want[f, r]).sum()) if got.shape == want[f, r].shape \
                    else want.shape[-1]
        self.log = []
        return {"bits_wrong": wrong, "missing": missing}
