"""Independent users' fused multiply+decrypt requests through the serving
executor: `BatchExecutor.submit_mul_decrypt`, ``flush()``, and each
future's ``(product, bit)``.

The mix's ``shapes`` are the ``[t1, t2]`` chunk counts of the requests.  A
request's operands are slices of one device pool of ``pool_bytes`` (every
chunk count holds the same number of operands, each a ciphertext of fresh
chunks of random bits), taken in an order drawn from the seed, so that no
operand is used twice before the pool is spent; the client makes the
`Ciphertext` wrappers as it submits.

The check compares every request's bit with the reference's parity of the
same operands, and the product words of `SAMPLE` requests drawn from the
seed (every shape among them); a request that never resolved is missing.
Only the sample's products are kept, so that the window's memory, and the
garbage collector's work, do not grow with the requests served.  The
control puts the reference in the program's place, with each product in
swapped chunk order.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import generator
from portbench.inputs import device_generator, fresh_chunks, host_rng
from portbench.reference import csgn

WARM_SECONDS = 1.0  # of the cell's own traffic before the window
SAMPLE = 2048       # requests whose product words are compared


class Op:
    def __init__(self, env):
        self.env = env
        self.shapes = [tuple(s) for s in env.traffic["shapes"]]

    def setup(self) -> None:
        env = self.env
        with env.stage("program import"):
            from csgn_tpu_torch import BatchExecutor, Ciphertext, Context, SecretKey
        self._ct = Ciphertext
        n, d = env.config["n"], env.config["d"]
        w = csgn.words_per_chunk(n)
        counts = sorted({t for s in self.shapes for t in s})
        per = env.traffic["pool_bytes"] // (4 * w * sum(counts))
        with env.stage("inputs"):
            gen = device_generator(env.seed, "pool", env.device)
            bits = torch.randint(0, 2, (per * sum(counts),), device=env.device, generator=gen)
            flat = fresh_chunks(bits, env.positions, n, gen)  # [chunks, W]
            self.pool, at = {}, 0
            for t in counts:
                self.pool[t] = flat[at:at + per * t].view(per, t, w).transpose(1, 2).contiguous()
                at += per * t
            del flat
            if env.device.type == "cuda":
                torch.cuda.synchronize(env.device)
        rng = host_rng(env.seed, "pool-order")
        self.order = {t: rng.permutation(per).tolist() for t in counts}
        self.next = dict.fromkeys(counts, 0)
        self.mask = torch.from_numpy(csgn.mask_words(env.positions, n)).to(env.device)
        with env.stage("program set-up"):
            self.ctx = Context(n, d)
            self.sk = SecretKey(self.ctx, env.positions, env.device)
            self.ex = BatchExecutor(self.sk)
        self.warm_schedule = generator.open_schedule(env.traffic, env.seed ^ 0x5EED,
                                                     WARM_SECONDS, env.rate)
        total = max(len(env.schedule.due), len(self.warm_schedule.due))
        self.slot_a = np.zeros(total, dtype=np.int64)
        self.slot_b = np.zeros(total, dtype=np.int64)
        self.shape_of = np.zeros(total, dtype=np.int64)
        self.bits = np.full(total, -1, dtype=np.int8)
        n_req = len(env.schedule.due)
        self.sampled = np.zeros(total, dtype=bool)
        self.sampled[host_rng(env.seed, "serve-sample").choice(n_req, min(SAMPLE, n_req),
                                                               replace=False)] = True
        self.kept: dict[int, object] = {}
        self.pending: list[int] = []

    def _slot(self, t: int) -> int:
        k = self.next[t]
        self.next[t] = k + 1
        order = self.order[t]
        return order[k % len(order)]

    def warm(self) -> None:
        """The cell's own traffic for `WARM_SECONDS` on a schedule of its own:
        every shape's kernels load and the caching allocator fills."""
        from portbench.harness import open_loop
        from portbench.tracing import Tracer

        open_loop(self, self.warm_schedule, Tracer(False, self.env.device))
        self.bits[:] = -1
        self.kept.clear()

    def submit(self, shape: int, k: int):
        t1, t2 = self.shapes[shape]
        ia = self.slot_a[k] = self._slot(t1)
        ib = self.slot_b[k] = self._slot(t2)
        self.shape_of[k] = shape
        if self.env.control:
            self.pending.append(k)
            return None
        return k, self.ex.submit_mul_decrypt(self._ct(self.pool[t1][ia], self.ctx),
                                             self._ct(self.pool[t2][ib], self.ctx))

    def flush(self) -> None:
        if not self.env.control:
            self.ex.flush()
            return
        for k in self.pending:
            t1, t2 = self.shapes[self.shape_of[k]]
            prod = csgn.control_product(self.pool[t1][self.slot_a[k]],
                                        self.pool[t2][self.slot_b[k]])
            self.bits[k] = csgn.match_count(prod, self.mask) & 1
            if self.sampled[k]:
                self.kept[k] = prod
        self.pending = []

    def result(self, handle) -> None:
        if handle is None:  # the control's, resolved at its flush
            return
        k, fut = handle
        prod, bit = fut.result()
        self.bits[k] = bit
        if self.sampled[k]:
            self.kept[k] = prod

    def check(self) -> dict:
        self.ex = self.sk = None
        n = len(self.env.schedule.due)
        shape_of, bits = self.shape_of[:n], self.bits[:n]
        missing = int((bits < 0).sum())
        bits_wrong = words_wrong = 0
        for s, (t1, t2) in enumerate(self.shapes):
            ks = np.flatnonzero((shape_of == s) & (bits >= 0))
            if not len(ks):
                continue
            dev = self.env.device
            ref = csgn.cross_and(self.pool[t1][torch.from_numpy(self.slot_a[ks]).to(dev)],
                                 self.pool[t2][torch.from_numpy(self.slot_b[ks]).to(dev)])
            parity = (csgn.matches(ref, self.mask).sum(dim=-1) & 1).cpu().numpy()
            bits_wrong += int((parity != bits[ks]).sum())
            rows = [r for r, k in enumerate(ks.tolist()) if k in self.kept]
            if rows:
                got = torch.stack([_words(self.kept[int(ks[r])]) for r in rows])
                words_wrong += int((got != ref[rows]).sum())
        self.kept = {}
        return {"bits_wrong": bits_wrong, "product_words_wrong": words_wrong,
                "missing": missing}


def _words(prod) -> torch.Tensor:
    """A product's words in the reference's chunk order."""
    if isinstance(prod, torch.Tensor):
        return prod
    return (prod if prod.is_canonical else prod.canonical()).wt
