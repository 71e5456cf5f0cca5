"""Serving executor: microbatch independent homomorphic requests.

Counterpart of `csgn_tpu.serve`.  A service sees *fleets* of small
independent requests, and the cost of a small op is its launch and host
overhead, not its device work.  `BatchExecutor` queues requests and runs
each *compatible group* as ONE batched call on the `CiphertextBatch` /
`encrypt_batch` / `decrypt_batch` kernels: B requests cost one launch per
group instead of B.  Grouping is by (op, context, chunk shape); incompatible
shapes land in different groups and still flush together.

Semantics:
  * `submit_*` returns a `ServeFuture`; nothing touches the device until
    `flush()` (or a group reaching `max_batch`, or the first
    `ServeFuture.result()` — results force a flush of everything pending).
  * Execution is deterministic: requests are batched in submission order,
    and each flush's randomness is derived from the executor's `rng.Key`
    (default ``rng.key(0)``) as the JAX executor derives it: encrypt flush
    i encrypts under ``fold_in(rng, i)`` and netlist flush i's public
    NOT-constant under ``fold_in(fold_in(rng, NETLIST_STREAM), i)`` (tag
    0x6E65), on the default engine.  Each stream counts only its own
    flushes, so re-running the same submissions reproduces every
    ciphertext, and the words equal the JAX executor's for the same key.
  * A request that fails validation at flush fails only its own future.
  * Single-threaded by design — the batching win is launch amortization,
    not host concurrency.  Wrap calls in a lock if driving from many threads.

Example::

    ex = BatchExecutor(sk, rng=rng.key(0))
    futs = [ex.submit_mul_decrypt(a, b) for a, b in requests]   # no device work
    ex.flush()                                                  # ~1 launch/group
    bits = [f.result()[1] for f in futs]
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from csgn_tpu_torch.batch import CiphertextBatch
from csgn_tpu_torch.ciphertext import Ciphertext
from csgn_tpu_torch.circuit import CtExpr, collect_leaves, lift, unpack_fleet_bits
from csgn_tpu_torch.models.netlist import (
    Netlist,
    _flatten_inputs,
    eval_homomorphic_batch,
    eval_plain_packed,
)
from csgn_tpu_torch.permutation import Permutation
from csgn_tpu_torch.pipeline import default_budget_bytes
from csgn_tpu_torch.rng import Key, fold_in
from csgn_tpu_torch.rng import key as make_key
from csgn_tpu_torch.secret_key import SecretKey
from csgn_tpu_torch.utils.metrics import op_metrics

__all__ = ["BatchExecutor", "ServeFuture", "NETLIST_STREAM"]

NETLIST_STREAM = 0x6E65   # the JAX executor's fold_in tag for NOT-constants

_M32 = 0xFFFFFFFF


class ServeFuture:
    """Result placeholder; `result()` flushes the executor if still pending."""

    __slots__ = ("_executor", "_value", "_exc", "_ready")

    def __init__(self, executor: "BatchExecutor"):
        self._executor = executor
        self._value = None
        self._exc: BaseException | None = None
        self._ready = False

    @property
    def done(self) -> bool:
        return self._ready

    def _set(self, value) -> None:
        self._value, self._ready = value, True

    def _set_exception(self, exc: BaseException) -> None:
        self._exc, self._ready = exc, True

    def result(self):
        if not self._ready:
            self._executor.flush()
        if self._exc is not None:
            raise self._exc
        return self._value


class _Failed:
    """A runner's result for one request that failed on its own."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def _stack(cts: list[Ciphertext]) -> CiphertextBatch:
    """Stack same-shape ciphertexts with one copy when the tags allow.

    All-canonical (fresh or already-canonicalized) requests stack raw;
    requests sharing ONE tag object (e.g. sliced from the same batch) keep
    it shared; mixed tags fall back to `CiphertextBatch.stack`, which
    canonicalizes each element (a gather per element — correct, not free).
    """
    first = cts[0]
    if all(c.logical is None for c in cts):
        return CiphertextBatch(torch.stack([c.wt for c in cts]), first.ctx)
    if all(c.logical is first.logical and c.pad == first.pad for c in cts):
        return CiphertextBatch(torch.stack([c.wt for c in cts]), first.ctx, first.logical,
                               first.pad)
    return CiphertextBatch.stack(cts)


class BatchExecutor:
    """Microbatching front-end over the batched CSGN kernels.

    Args:
      key: `SecretKey` used by encrypt / decrypt / mul_decrypt / netlist /
        circuit requests (pure ciphertext ops work without one).
      rng: base `rng.Key` of the executor's randomness (default
        ``rng.key(0)``, as the JAX executor's ``jax.random.key(0)``); each
        flush folds in its index, so ciphertexts are reproducible given
        (rng, submission order) and equal the JAX executor's.
      max_batch: a group reaching this many requests flushes immediately
        (bounds peak device memory for the stacked batch); None = unbounded.
      netlist_budget_bytes: materialization budget enforced by the
        `submit_netlist` route (default: the chain budget of the key's
        device, `pipeline.default_budget_bytes`); None disables it.
        `submit_netlist_expr` never materializes and ignores this.
    """

    def __init__(
        self,
        key: SecretKey | None = None,
        *,
        rng: Key | None = None,
        max_batch: int | None = 4096,
        netlist_budget_bytes: "int | None" = ...,  # ... = the key device's default
    ):
        if netlist_budget_bytes is ...:
            netlist_budget_bytes = default_budget_bytes(key.device if key else "cpu")
        if rng is not None and not isinstance(rng, Key):
            raise TypeError(f"BatchExecutor: rng must be an rng.Key, got {type(rng).__name__}")
        self._key = key
        self._rng = make_key(0) if rng is None else rng
        self._max_batch = max_batch
        self._netlist_budget = netlist_budget_bytes
        self._groups: dict[tuple, list[tuple]] = {}
        self._enc_flushes = 0  # each stream counts only its own flushes
        self._net_flushes = 0
        self.stats = {"requests": 0, "flushes": 0, "group_dispatches": 0}

    # -- submission -------------------------------------------------------------

    def _need_key(self, what: str) -> SecretKey:
        if self._key is None:
            raise ValueError(f"{what} requests need a BatchExecutor(key=...)")
        return self._key

    def _enqueue(self, group_key: tuple, payload: tuple) -> ServeFuture:
        fut = ServeFuture(self)
        pending = self._groups.setdefault(group_key, [])
        pending.append((payload, fut))
        self.stats["requests"] += 1
        if self._max_batch is not None and len(pending) >= self._max_batch:
            self._flush_group(group_key)
        return fut

    def _check_ct(self, ct: Ciphertext, what: str) -> None:
        if not isinstance(ct, Ciphertext):
            raise TypeError(f"{what} expects Ciphertext, got {type(ct).__name__}")
        if self._key is not None and ct.ctx != self._key.ctx:
            raise ValueError(f"{what}: ciphertext context differs from the key's")

    def submit_encrypt(self, bit: int) -> ServeFuture:
        """Encrypt one bit; B queued encrypts become one `encrypt_batch`."""
        self._need_key("encrypt")
        return self._enqueue(("enc",), (int(bit) & 1,))

    def submit_add(self, a: Ciphertext, b: Ciphertext) -> ServeFuture:
        self._check_ct(a, "add"), self._check_ct(b, "add")
        if a.ctx != b.ctx:
            raise ValueError("add: operand context mismatch")
        return self._enqueue(("add", a.ctx, a.chunks, b.chunks), (a, b))

    def submit_mul(self, a: Ciphertext, b: Ciphertext) -> ServeFuture:
        self._check_ct(a, "mul"), self._check_ct(b, "mul")
        if a.ctx != b.ctx:
            raise ValueError("mul: operand context mismatch")
        return self._enqueue(("mul", a.ctx, a.chunks, b.chunks), (a, b))

    def submit_decrypt(self, ct: Ciphertext) -> ServeFuture:
        """Decrypt; resolves to an int bit."""
        self._need_key("decrypt")
        self._check_ct(ct, "decrypt")
        return self._enqueue(("dec", ct.ctx, ct.chunks), (ct,))

    def submit_mul_decrypt(self, a: Ciphertext, b: Ciphertext) -> ServeFuture:
        """Fused multiply+decrypt; resolves to ``(product, bit)``."""
        self._need_key("mul_decrypt")
        self._check_ct(a, "mul_decrypt"), self._check_ct(b, "mul_decrypt")
        if a.ctx != b.ctx:
            raise ValueError("mul_decrypt: operand context mismatch")
        return self._enqueue(("muldec", a.ctx, a.chunks, b.chunks), (a, b))

    def submit_netlist(self, netlist: Netlist, inputs) -> ServeFuture:
        """Evaluate a Bristol netlist over one request's encrypted inputs;
        resolves to the nested output list (``list[list[Ciphertext]]``).

        B queued same-circuit requests (same netlist, context, and per-wire
        chunk shapes) run as ONE batched evaluation: each input wire stacks
        across requests into a `CiphertextBatch` and every gate is one
        batched launch for the whole fleet
        (`models.netlist.eval_homomorphic_batch`).  Requires a key (the
        NOT-constant is an encryption of 1 on `NETLIST_STREAM`).
        """
        return self._submit_netlist_common("net", "netlist", netlist, inputs)

    def _submit_netlist_common(self, kind: str, label: str, netlist, inputs) -> ServeFuture:
        """Shared validation + enqueue for both netlist routes."""
        self._need_key(label)
        if not isinstance(netlist, Netlist):
            raise TypeError(f"expected Netlist, got {type(netlist).__name__}")
        inputs = tuple(tuple(v) for v in inputs)
        flat = _flatten_inputs(netlist, inputs)
        for ct in flat:
            self._check_ct(ct, label)
        shapes = tuple(ct.chunks for ct in flat)
        return self._enqueue((kind, netlist, self._key.ctx, shapes), (netlist, inputs))

    def submit_netlist_expr(self, netlist: Netlist, inputs) -> ServeFuture:
        """Evaluate a netlist growth-free and decrypt its outputs; resolves
        to the nested BIT list (``list[list[int]]``, mirroring
        ``output_sizes``).

        The fleet route for DEEP circuits (AES-128 / SHA-256 class, where
        `submit_netlist` would materialize superlinear chunk growth): B
        queued same-circuit requests stack each input wire into a
        `CiphertextBatch`, the wires decrypt in one batched launch per chunk
        shape, and one packed evaluation reads out every request's bits.
        Key-side by necessity — the results are decrypted bits.
        """
        return self._submit_netlist_common("netexpr", "netlist_expr", netlist, inputs)

    def submit_decrypt_circuit(self, expr) -> ServeFuture:
        """Decrypt a +/* DAG (`CtExpr` or Ciphertext); resolves to an int bit
        (or a uint8[B] array when the DAG has `CiphertextBatch` fleet leaves).

        All pending circuit requests flush as ONE `SecretKey.decrypt_circuits`
        call.  Submission spot-checks one leaf's context (walking every leaf
        would cost O(gates) per submitted output of a shared DAG); a request
        with a leaf under another context fails its own future at flush,
        and the rest of its group still resolves.
        """
        sk = self._need_key("decrypt_circuit")
        if isinstance(expr, Ciphertext):
            self._check_ct(expr, "decrypt_circuit")
        elif isinstance(expr, CtExpr):
            if expr._any_leaf().ctx != sk.ctx:
                raise ValueError("decrypt_circuit: leaf context differs from the key's")
        else:
            raise TypeError(
                f"decrypt_circuit expects CtExpr or Ciphertext, got {type(expr).__name__}"
            )
        return self._enqueue(("deccirc", sk.ctx), (expr,))

    def submit_permute(self, ct: Ciphertext, perm: Permutation) -> ServeFuture:
        """Apply a per-request permutation; B requests run the batched
        stacked-plan Beneš kernel (one launch for the whole fleet)."""
        self._check_ct(ct, "permute")
        if perm.n != ct.ctx.n:
            raise ValueError(f"permutation length {perm.n} != context n {ct.ctx.n}")
        return self._enqueue(("perm", ct.ctx, ct.chunks), (ct, perm))

    # -- execution ----------------------------------------------------------------

    def pending(self) -> int:
        return sum(len(v) for v in self._groups.values())

    def flush(self) -> None:
        """Execute every pending group (one batched call per group)."""
        if not self._groups:
            return
        self.stats["flushes"] += 1
        for group_key in list(self._groups):
            self._flush_group(group_key)

    def _flush_group(self, group_key: tuple) -> None:
        pending = self._groups.pop(group_key, [])
        if not pending:
            return
        payloads = [p for p, _ in pending]
        futures = [f for _, f in pending]
        self.stats["group_dispatches"] += 1
        runner: Callable = getattr(self, f"_run_{group_key[0]}")
        try:
            with op_metrics().record(f"serve.{group_key[0]}", chunks_in=len(pending)):
                results = runner(payloads)
        except Exception as exc:  # noqa: BLE001 — delivered via the futures
            for f in futures:
                f._set_exception(exc)
            return
        for f, r in zip(futures, results):
            if isinstance(r, _Failed):
                f._set_exception(r.exc)
            else:
                f._set(r)

    # Per-kind batched runners: each is ONE batched device computation.

    def _run_enc(self, payloads: list[tuple]) -> list[Ciphertext]:
        sk = self._need_key("encrypt")
        bits = torch.tensor([p[0] for p in payloads], dtype=torch.int32)
        subkey = fold_in(self._rng, self._enc_flushes)
        self._enc_flushes += 1
        batch = CiphertextBatch.from_fresh(sk.encrypt_batch(bits, subkey), sk.ctx)  # [W, B]
        return [batch[i] for i in range(len(payloads))]

    def _run_add(self, payloads: list[tuple]) -> list[Ciphertext]:
        out = _stack([a for a, _ in payloads]) + _stack([b for _, b in payloads])
        return [out[i] for i in range(len(payloads))]

    def _run_mul(self, payloads: list[tuple]) -> list[Ciphertext]:
        out = _stack([a for a, _ in payloads]) * _stack([b for _, b in payloads])
        return [out[i] for i in range(len(payloads))]

    def _run_dec(self, payloads: list[tuple]) -> list[int]:
        sk = self._need_key("decrypt")
        return sk.decrypt_batch(_stack([p[0] for p in payloads])).tolist()

    def _run_muldec(self, payloads: list[tuple]) -> list[tuple[Ciphertext, int]]:
        sk = self._need_key("mul_decrypt")
        out, bits = sk.mul_and_decrypt_batch(_stack([a for a, _ in payloads]),
                                             _stack([b for _, b in payloads]))
        return [(out[i], bit) for i, bit in enumerate(bits.tolist())]

    @staticmethod
    def _stack_wires(payloads: list[tuple]) -> list[list[CiphertextBatch]]:
        """Stack each input wire across the group's requests (both netlist
        runners share this shape)."""
        return [
            [_stack([p[1][v][j] for p in payloads]) for j in range(len(payloads[0][1][v]))]
            for v in range(len(payloads[0][1]))
        ]

    def _run_net(self, payloads: list[tuple]) -> list[list[list[Ciphertext]]]:
        sk = self._need_key("netlist")
        netlist = payloads[0][0]  # the group key pins one netlist per group
        one = sk.encrypt(1, fold_in(fold_in(self._rng, NETLIST_STREAM), self._net_flushes))
        self._net_flushes += 1
        # Deep circuits explode materialized growth: the budget check rejects
        # them before the first superlinear multiply allocates.
        out_batches = eval_homomorphic_batch(netlist, self._stack_wires(payloads), one,
                                             budget_bytes=self._netlist_budget)
        return [[[cb[i] for cb in value] for value in out_batches]
                for i in range(len(payloads))]

    def _run_netexpr(self, payloads: list[tuple]) -> list[list[list[int]]]:
        """Key-side fleet readout: decrypting a netlist's expr DAG folds to
        plain evaluation over the decrypted input bits (Dec is a ring
        homomorphism), so this route skips building the DAG — decrypt every
        input wire batch (one launch per chunk shape), then run the circuit
        once on packed bit-masks (`eval_plain_packed`, one int op per gate
        for the whole group).  Bit-exact to eval_expr + decrypt_circuits."""
        sk = self._need_key("netlist_expr")
        netlist = payloads[0][0]
        b = len(payloads)
        stacked = self._stack_wires(payloads)
        it = iter(sk.decrypt_batches_packed([cb for value in stacked for cb in value]))
        packed_inputs = [[next(it) for _ in value] for value in stacked]
        outs = eval_plain_packed(netlist, packed_inputs, b)
        out_vecs = [[unpack_fleet_bits(v, b) for v in value] for value in outs]
        return [[[int(vec[i]) for vec in value] for value in out_vecs] for i in range(b)]

    def _run_deccirc(self, payloads: list[tuple]) -> list:
        sk = self._need_key("decrypt_circuit")
        exprs = [lift(p[0]) for p in payloads]
        # One walk over the union of the DAGs; only if some leaf is under
        # another context, find the requests that hold one.
        failed = {}
        if any(ct.ctx != sk.ctx for ct in collect_leaves(exprs)):
            for i, e in enumerate(exprs):
                if any(ct.ctx != sk.ctx for ct in e.leaves()):
                    failed[i] = _Failed(ValueError(
                        "decrypt_circuit: leaf context differs from the key's"))
        good = [i for i in range(len(exprs)) if i not in failed]
        vals = iter(sk.decrypt_circuits([exprs[i] for i in good]))
        # Fleet DAGs resolve to uint8[B] arrays, scalar DAGs to int bits.
        out = []
        for i in range(len(exprs)):
            if i in failed:
                out.append(failed[i])
            else:
                v = next(vals)
                out.append(v if isinstance(v, np.ndarray) else int(v))
        return out

    def _run_perm(self, payloads: list[tuple]) -> list[Ciphertext]:
        out = _stack([ct for ct, _ in payloads]).apply_permutations(
            [perm for _, perm in payloads])
        return [out[i] for i in range(len(payloads))]

    def __repr__(self) -> str:
        return (
            f"BatchExecutor(pending={self.pending()}, "
            f"requests={self.stats['requests']}, "
            f"group_dispatches={self.stats['group_dispatches']})"
        )
