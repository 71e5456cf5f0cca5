"""A key-rotation fleet server: stored ciphertexts re-keyed for delegated
readers a fleet at a time, through `BatchExecutor.submit_permute` on an
executor that holds no key (a closed loop of one server).

The mix's ``shapes`` hold one ``[fleet, chunks]``, ``sets`` the stored
fleets and ``readers`` the readers, each with a long-lived permutation π_r
drawn from the seed, whose Beneš plan is built at set-up.  The store is
``sets * fleet`` ciphertexts of `chunks` fresh chunks of random bits, made
on the device.  Request j of set s goes to reader (j + s) mod readers, so a
fleet of `readers` requests stacks one plan of each.

An op is one whole fleet: a ``submit_permute`` per request, one ``flush()``,
every ``result()``, then a wait on the stream, the server's hand-off point
(the rotated ciphertexts stay on the card for the readers to fetch; nothing
is copied to the host).  It counts its fleet's chunks; its least bytes are
each request read once and written once, 2 * 4 * W * chunks a request, and
its least operations the Beneš networks of its requests' plans
(`portbench.rekey_work`), which it counts into the window.

`warm` runs every set once, holding what the window holds at once, so that
the caching allocator has every block before the window.  In a traced run
it then switches the program's span recorder on (reset there, so the
recorder holds the window's spans and counts alone), for
``perm.stack_plans_us.fleet`` and ``perm.plan_upload_kb.fleet``, and
`check` switches it off.  `check` logs the window's ``perm.plan_builds`` (0:
every plan was built at set-up) and ``apply_benes_batch.register`` (one a
fleet on the card's register path).

The check keeps, for each set, one of its first three fleets and from it
`SAMPLE_REQUESTS` requests drawn from the seed, and one request of the
fleet in flight when the window closed.  It compares their rotated words
with the reference's rotation of the stored ciphertext, and their bits
under π_r(k) with Dec_k of the stored ciphertext (`reference.fleet`); a set
whose kept fleet never ran counts in ``sets_unchecked``.  The control
rotates with π_r⁻¹ in π_r's place.
"""

from __future__ import annotations

import torch

from portbench import rekey_work
from portbench.harness import log
from portbench.inputs import device_generator, fresh_chunks, host_rng
from portbench.reference import csgn
from portbench.reference import fleet as reference

SAMPLE_USES = 3      # a kept fleet is one of its set's first uses
SAMPLE_REQUESTS = 4  # requests kept of it


class Op:
    unit = "chunks"

    def __init__(self, env):
        self.env = env
        ((self.fleet, self.chunks),) = env.traffic["shapes"]
        self.sets = env.traffic["sets"]
        self.readers = env.traffic["readers"]

    def _reader(self, s: int, j: int) -> int:
        return (j + s) % self.readers

    def setup(self) -> None:
        env = self.env
        with env.stage("program import"):
            from csgn_tpu_torch import BatchExecutor, Ciphertext, Context, Permutation
            from csgn_tpu_torch.utils.metrics import op_metrics
        self.metrics = op_metrics()
        n, d = env.config["n"], env.config["d"]
        with env.stage("inputs"):
            gen = device_generator(env.seed, "store", env.device)
            w = csgn.words_per_chunk(n)
            self.store = torch.empty((self.sets, self.fleet, w, self.chunks), dtype=torch.int32,
                                     device=env.device)
            for s in range(self.sets):
                bits = torch.randint(0, 2, (self.fleet, self.chunks), device=env.device,
                                     generator=gen)
                self.store[s] = fresh_chunks(bits, env.positions, n, gen).transpose(1, 2)
            if env.device.type == "cuda":
                torch.cuda.synchronize(env.device)
        self.perms = [host_rng(env.seed, f"reader-{r}").permutation(n)
                      for r in range(self.readers)]
        with env.stage("program set-up"):
            self.ctx = Context(n, d)
            self.ex = BatchExecutor(None)
            self.cts = [[Ciphertext(self.store[s, j], self.ctx) for j in range(self.fleet)]
                        for s in range(self.sets)]
        with env.stage("plans"):
            rotations = [p.argsort() if env.control else p for p in self.perms]
            self.pis = [Permutation(p) for p in rotations]
            reader_ops = [rekey_work.network_ops(pi.benes_plan()) for pi in self.pis]
        self.fleet_ops = [self.chunks * sum(reader_ops[self._reader(s, j)]
                                            for j in range(self.fleet))
                          for s in range(self.sets)]
        self.request_bytes = 2 * 4 * self.ctx.words32 * self.chunks
        rng = host_rng(env.seed, "rotate-sample")
        self.keep = {s: (int(rng.integers(SAMPLE_USES)),
                         rng.choice(self.fleet, min(SAMPLE_REQUESTS, self.fleet),
                                    replace=False).tolist())
                     for s in range(self.sets)}
        self.last_request = int(rng.integers(self.fleet))
        self.uses = [0] * self.sets
        self.kept: dict[int, list] = {}
        self.last = None
        self.ops = self.failed_fleets = 0

    def _fleet(self, s: int) -> list:
        """One fleet through the program: its requests' rotated ciphertexts
        (or exceptions), once the stream has drained."""
        cts, pis = self.cts[s], self.pis
        futs = [self.ex.submit_permute(cts[j], pis[self._reader(s, j)])
                for j in range(self.fleet)]
        self.ex.flush()
        outs = []
        for fut in futs:
            try:
                outs.append(fut.result())
            except Exception as exc:  # noqa: BLE001 - a failed request is missing
                outs.append(exc)
        if self.env.device.type == "cuda":
            torch.cuda.current_stream(self.env.device).synchronize()
        return outs

    def warm(self) -> None:
        held = []
        for s in range(self.sets):
            outs = self._fleet(s)
            held += [outs[j].wt.clone() for j in self.keep[s][1]]
            last = outs[self.last_request]
        del held, last, outs
        self.metrics.reset()
        if self.env.tracer.enabled:
            self.metrics.enable()

    def run(self, item, k: int):
        s = item[1]
        with self.env.tracer.span("rotate.fleet", sync=True):
            outs = self._fleet(s)
        failed = [o for o in outs if isinstance(o, Exception)]
        if failed:
            self.failed_fleets += 1
            if self.failed_fleets <= 3:
                log(f"fleet {k} (set {s}): {len(failed)} requests failed, the first: {failed[0]!r}")
        use, (keep_use, requests) = self.uses[s], self.keep[s]
        self.uses[s] = use + 1
        if use == keep_use:
            self.kept[s] = [(j, outs[j].wt.clone()) for j in requests
                            if not isinstance(outs[j], Exception)]
        self.last = (s, self.last_request, outs[self.last_request])
        self.ops += 1
        rekey_work.add_ops(self.env.tracer, self.fleet_ops[s])
        return self.fleet * self.chunks, self.fleet * self.request_bytes, self.fleet, len(failed)

    def check(self) -> dict:
        self.metrics.disable()
        snap = self.metrics.snapshot()
        counts = {k: snap.get(k, {}).get("calls", 0)
                  for k in ("perm.plan_builds", "apply_benes_batch.register")}
        log(f"in the window of {self.ops} fleets: "
            + ", ".join(f"{k} {v}" for k, v in counts.items()))
        self.ex = self.cts = self.pis = None  # the program's state goes before the reference runs
        sample = [(s, j, words) for s, kept in self.kept.items() for j, words in kept]
        if self.last is not None and not isinstance(self.last[2], Exception):
            s, j, ct = self.last
            sample.append((s, j, ct.wt))
        n = self.env.config["n"]
        wrong = bits_wrong = 0
        for s, j, rot in sample:
            w, b = reference.check(rot, self.store[s, j], self.perms[self._reader(s, j)],
                                   self.env.positions, n)
            wrong += w
            bits_wrong += b
        unchecked = self.sets - len(self.kept)
        sample = self.kept = self.last = None
        return {"rotated_words_wrong": int(wrong), "bits_wrong": int(bits_wrong),
                "sets_unchecked": int(unchecked)}
