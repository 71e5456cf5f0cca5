"""The key holder's fused multiply+decrypt in bulk: `SecretKey.mul_and_decrypt`
on large products, one op at a time (a closed loop of one client).

The mix's ``shapes`` are ``[t1, t2]`` chunk counts and ``sets`` the distinct
operand pairs of each; every operand is a ciphertext of fresh chunks of
random bits.  An op counts its t1 * t2 product chunks, and needs its
operands read once and its product written once: W * 4 * (t1 + t2 + t1 * t2)
bytes.

The check compares every op's decrypted bit with the reference's parity of
the same operands, and the product words of a sample of ops drawn from the
seed: for each operand pair, one of its first three uses (a pair whose
product went uncompared fails the check), and the op in flight when the
window closed.  The control puts the reference in the
program's place with the product in swapped chunk order.
"""

from __future__ import annotations

import torch

from portbench.inputs import device_generator, fresh_chunks, host_rng
from portbench.reference import csgn

SAMPLE_USES = 3  # a kept product is one of its pair's first uses


class Op:
    unit = "chunks"

    def __init__(self, env):
        self.env = env
        self.shapes = [tuple(s) for s in env.traffic["shapes"]]
        self.items = [(s, j) for s in range(len(self.shapes)) for j in range(env.traffic["sets"])]

    def setup(self) -> None:
        env = self.env
        with env.stage("program import"):
            from csgn_tpu_torch import Ciphertext, Context, SecretKey
        n, d = env.config["n"], env.config["d"]
        with env.stage("inputs"):
            gen = device_generator(env.seed, "operands", env.device)
            self.words = {}
            for item in self.items:
                t1, t2 = self.shapes[item[0]]
                pair = []
                for t in (t1, t2):
                    bits = torch.randint(0, 2, (t,), device=env.device, generator=gen)
                    pair.append(fresh_chunks(bits, env.positions, n, gen).T.contiguous())
                self.words[item] = tuple(pair)
            if env.device.type == "cuda":
                torch.cuda.synchronize(env.device)
        with env.stage("program set-up"):
            self.ctx = Context(n, d)
            self.sk = SecretKey(self.ctx, env.positions, env.device)
            self.cts = {item: tuple(Ciphertext(w, self.ctx) for w in pair)
                        for item, pair in self.words.items()}
        rng = host_rng(env.seed, "muldec-sample")
        self.keep = {(item, int(rng.integers(SAMPLE_USES))) for item in self.items}
        self.uses = dict.fromkeys(self.items, 0)
        self.bits: list[tuple[tuple, int]] = []
        self.kept: list[tuple[tuple, object]] = []
        self.last = None

    def _call(self, item):
        """The timed call: ``(product words [W, t1 * t2], bit)``."""
        if self.env.control:
            a, b = self.words[item]
            prod = csgn.control_product(a, b)
            return prod, csgn.match_count(prod, self._mask()) & 1
        prod, bit = self.sk.mul_and_decrypt(*self.cts[item])
        return prod, int(bit)

    def _mask(self) -> torch.Tensor:
        return torch.from_numpy(csgn.mask_words(self.env.positions, self.env.config["n"])).to(
            self.env.device)

    def warm(self) -> None:
        """Every operand pair once, holding as many products as the window
        holds at once (the sample, the last op and the one in flight), so
        that the caching allocator has every block before the window."""
        held = [self._call(item)[0] for item in self.items]
        held += [self._call(self.items[0])[0], self._call(self.items[-1])[0]]
        del held

    def run(self, item, k: int):
        t1, t2 = self.shapes[item[0]]
        with self.env.tracer.span("key.mul_and_decrypt", sync=True):
            prod, bit = self._call(item)
        self.bits.append((item, bit))
        use = self.uses[item]
        self.uses[item] = use + 1
        if (item, use) in self.keep:
            self.kept.append((item, prod))
        self.last = (item, prod)
        w = self.ctx.words32
        return t1 * t2, w * 4 * (t1 + t2 + t1 * t2), 1, 0

    def check(self) -> dict:
        self.sk = self.cts = None  # the program's state goes before the reference runs
        mask = self._mask()
        sample = self.kept + ([self.last] if self.last is not None else [])
        parity, wrong = {}, 0
        for item, prod in sample:
            words = prod
            if not isinstance(prod, torch.Tensor):
                words = (prod if prod.is_canonical else prod.canonical()).wt
            bad, parity[item] = csgn.check_product(words, *self.words[item], mask)
            wrong += bad
        sample = self.kept = self.last = None
        unchecked = [item for item in self.items if item not in parity]
        for item in unchecked:
            parity[item] = csgn.check_product(None, *self.words[item], mask)[1]
        bits_wrong = sum(bit != parity[item] for item, bit in self.bits)
        return {"bits_wrong": int(bits_wrong), "product_words_wrong": int(wrong),
                "pairs_unchecked": len(unchecked)}
