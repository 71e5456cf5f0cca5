"""A compute server's products re-keyed for delegated readers: ``prod = a *
b``, then ``SecretKey.permute_and_decrypt(prod, π_r)``, one op at a time (a
closed loop of one client).

The mix is `muldec`'s (``shapes``, ``sets``, the same operands and sample)
plus ``readers``, each with a long-lived permutation π_r drawn from the
seed; set s goes to reader s mod readers.  The readers' Beneš plans are
built, and each used once, in `warm`, so no plan is built inside the
window (the program's counter ``perm.plan_builds``, logged by the check,
shows it).  An op counts its t1 * t2 product chunks; its least work is
`portbench.rekey_work`'s, which the op counts into the window.

In a traced run the op switches the program's span recorder on at the end
of `warm` (reset there, so the recorder holds the window's spans alone),
for `key.rekey_host_us`, and off in `check`.

The check compares every op's decrypted bit with the reference's parity
of the same operands under the key k (Dec_{π(k)}(π(c)) = Dec_k(c)), and the
rotated product words of `muldec`'s sample (one of each operand pair's
first three uses, and the op in flight when the window closed) against the
reference's rotation of the reference's product.  The control rotates with
π_r⁻¹ in π_r's place, under the same key: its bits decrypt right and its
words are wrong.
"""

from __future__ import annotations

import numpy as np

from portbench import rekey_work
from portbench.harness import log
from portbench.inputs import host_rng
from portbench.ops import muldec
from portbench.reference import csgn, rekey


class Op(muldec.Op):
    def setup(self) -> None:
        super().setup()
        from csgn_tpu_torch import Permutation
        from csgn_tpu_torch.utils.metrics import op_metrics

        self.metrics = op_metrics()
        n = self.env.config["n"]
        self.perms = [host_rng(self.env.seed, f"reader-{r}").permutation(n)
                      for r in range(self.env.traffic["readers"])]
        rotations = [np.argsort(p) if self.env.control else p for p in self.perms]
        self.pis = [Permutation(p) for p in rotations]

    def _reader(self, item) -> int:
        return item[1] % len(self.perms)

    def _call(self, item):
        """The timed call: ``(rotated product, bit)``."""
        a, b = self.cts[item]
        rot, bit = self.sk.permute_and_decrypt(a * b, self.pis[self._reader(item)])
        return rot, int(bit)

    def warm(self) -> None:
        super().warm()
        self.ops_per_chunk = [rekey_work.network_ops(pi.benes_plan()) for pi in self.pis]
        self.metrics.reset()
        if self.env.tracer.enabled:
            self.metrics.enable()

    def run(self, item, k: int):
        t1, t2 = self.shapes[item[0]]
        with self.env.tracer.span("rekey", sync=True):
            rot, bit = self._call(item)
        self.bits.append((item, bit))
        use = self.uses[item]
        self.uses[item] = use + 1
        if (item, use) in self.keep:
            self.kept.append((item, rot))
        self.last = (item, rot)
        rekey_work.add_ops(self.env.tracer, self.ops_per_chunk[self._reader(item)] * t1 * t2)
        return t1 * t2, rekey_work.op_bytes(self.ctx.words32, t1, t2), 1, 0

    def check(self) -> dict:
        self.metrics.disable()
        builds = self.metrics.snapshot().get("perm.plan_builds", {}).get("calls", 0)
        log(f"perm.plan_builds in the window: {builds}")
        self.sk = self.cts = self.pis = None  # the program's state goes before the reference runs
        mask = self._mask()
        sample = self.kept + ([self.last] if self.last is not None else [])
        parity, wrong = {}, 0
        for item, rot in sample:
            words = (rot if rot.is_canonical else rot.canonical()).wt
            bad, parity[item] = rekey.check_rotated(words, *self.words[item],
                                                    self.perms[self._reader(item)], mask)
            wrong += bad
        sample = self.kept = self.last = None
        unchecked = [item for item in self.items if item not in parity]
        for item in unchecked:
            parity[item] = csgn.check_product(None, *self.words[item], mask)[1]
        bits_wrong = sum(bit != parity[item] for item, bit in self.bits)
        return {"bits_wrong": int(bits_wrong), "rotated_words_wrong": int(wrong),
                "pairs_unchecked": len(unchecked)}
