"""Virtual ciphertext circuits: +/* DAGs evaluated key-side without growth.

Counterpart of `csgn_tpu.circuit`.  Decryption is a ring homomorphism from
(ciphertexts, +, *) onto (F2, xor, and) (reference src/SecretKey.cpp:126-146:
the parity of a concatenation is the xor of parities; the parity of a chunk
cross-product is the and):

    Dec(a + b) = Dec(a) ^ Dec(b)        Dec(a * b) = Dec(a) & Dec(b)

So the key holder can decrypt ANY +/* circuit of ciphertexts in O(sum of leaf
chunks) — decrypt each distinct leaf once, fold bits through the DAG — while
the *materialized* ciphertext would have product-of-chunk-counts chunks.  A
32-deep multiply chain of 2-chunk inputs materializes to 2^32 chunks (687 GB
at Context(1247,16), beyond one card's memory); its `CtExpr` decrypts from
the 32 fresh leaves.

`CtExpr` is the lazy counterpart of `Ciphertext`: the same operator surface
(+, *, apply_permutation), no device work until `materialize()`.  Evaluation
is iterative (explicit stack) and memoized on node identity, so shared
subexpressions — true DAGs, not just trees — cost one visit, and depth is not
limited by Python recursion.

Leaves may also be `CiphertextBatch`es: ONE DAG then serves B instances —
leaf bits become packed ints (instance i at bit i) and the fold's xor/and
run across the fleet (scalar leaves, e.g. the public NOT-constant, broadcast
to 0 or the all-instances mask).  A B-fleet of a deep circuit costs one
batched decrypt per distinct leaf shape plus ONE DAG walk, instead of B
scalar walks.

Non-key-holders cannot fold chunks (a chunk's decrypt bit is keyed), which is
why this lives next to `SecretKey.decrypt_product`/`recrypt` as the key-side
escape hatch for the scheme's bounded (superlinear-growth) multiplication.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np

from csgn_tpu_torch.batch import CiphertextBatch
from csgn_tpu_torch.ciphertext import Ciphertext

if typing.TYPE_CHECKING:
    from csgn_tpu_torch.permutation import Permutation

__all__ = [
    "CtExpr",
    "lift",
    "fold_many",
    "collect_leaves",
    "pack_fleet_bits",
    "unpack_fleet_bits",
    "CHUNKS_SAT",
    "sat_add",
    "sat_mul",
]


def pack_fleet_bits(bits) -> int:
    """Bit vector (uint8[B] / list) -> one Python int, instance i at bit i.

    Fleet folds run on packed ints: one native int xor/and per gate instead
    of a ~1 µs numpy dispatch on a uint8[B] array — ~10× less host time per
    gate on published-size circuits, at ANY fleet size (Python ints are
    arbitrary precision)."""
    arr = np.asarray(bits, dtype=np.uint8) & 1
    return int.from_bytes(np.packbits(arr, bitorder="little").tobytes(), "little")


def unpack_fleet_bits(v: int, b: int) -> np.ndarray:
    """Inverse of `pack_fleet_bits`: the low ``b`` bits as uint8[b]."""
    nbytes = (b + 7) // 8
    raw = np.frombuffer(v.to_bytes(nbytes, "little"), dtype=np.uint8)
    return np.unpackbits(raw, bitorder="little")[:b]

CHUNKS_SAT = 1 << 63
"""Chunk-count accounting saturates here.

Chunk counts are *metadata* (HBM budgeting, `nbytes_materialized`); computing
them exactly for deep circuits is itself infeasible — an AND-depth-40 circuit
(AES-128) has exact chunk counts with ~10^24 BITS, so unbounded Python-int
accounting hangs before any device work starts.  2^63 chunks is astronomically
beyond any device memory (and any budget guard's threshold), and every count below the
cap stays exact, so saturation changes no reachable decision.
"""


def sat_add(a: int, b: int) -> int:
    """``a + b`` capped at `CHUNKS_SAT` (exact below the cap)."""
    s = a + b
    return s if s < CHUNKS_SAT else CHUNKS_SAT


def sat_mul(a: int, b: int) -> int:
    """``a * b`` capped at `CHUNKS_SAT` (exact below the cap)."""
    if a and b > CHUNKS_SAT // a:
        return CHUNKS_SAT
    return a * b


def lift(x: "Ciphertext | CiphertextBatch | CtExpr") -> "CtExpr":
    """Wrap a Ciphertext (or a `CiphertextBatch` — one leaf, B instances)
    as a leaf expression (no-op on expressions)."""
    if isinstance(x, CtExpr):
        return x
    if isinstance(x, CiphertextBatch):
        return CtExpr(op="leaf", ct=x, args=(), chunks=x.chunks, batch=x.batch)
    if isinstance(x, Ciphertext):
        return CtExpr(op="leaf", ct=x, args=(), chunks=x.chunks)
    raise TypeError(f"cannot lift {type(x).__name__} into a circuit")


def _merge_batch(a: "int | None", b: "int | None") -> "int | None":
    """Fleet sizes must agree exactly across a DAG (None = scalar leaf,
    which broadcasts).  B=1 vs B=3 is rejected too — silently recycling one
    instance's ciphertext across a fleet is exactly the under-stacking bug
    this guard exists to catch (mirrors eval_homomorphic_batch's check)."""
    if a is None:
        return b
    if b is None or a == b:
        return a
    raise ValueError(f"fleet batch mismatch in circuit: {a} vs {b}")


@dataclasses.dataclass(frozen=True)
class CtExpr:
    """A +/* DAG over ciphertext leaves; `chunks` is the materialized size."""

    op: str                            # "leaf" | "add" | "mul"
    ct: "Ciphertext | CiphertextBatch | None"  # leaf payload
    args: tuple["CtExpr", ...]         # operands for add/mul
    chunks: int                        # materialized chunk count (per element
                                       # for batch leaves), capped at CHUNKS_SAT
    batch: "int | None" = None         # fleet size; None = scalar-leaf-only DAG

    # -- construction ---------------------------------------------------------

    def __add__(self, other: "Ciphertext | CiphertextBatch | CtExpr") -> "CtExpr":
        other = lift(other)
        return CtExpr(
            "add",
            None,
            (self, other),
            sat_add(self.chunks, other.chunks),
            _merge_batch(self.batch, other.batch),
        )

    __radd__ = __add__

    def __mul__(self, other: "Ciphertext | CiphertextBatch | CtExpr") -> "CtExpr":
        other = lift(other)
        return CtExpr(
            "mul",
            None,
            (self, other),
            sat_mul(self.chunks, other.chunks),
            _merge_batch(self.batch, other.batch),
        )

    __rmul__ = __mul__

    def apply_permutation(self, p: "Permutation") -> "CtExpr":
        """Permutation distributes over +/* chunk-wise (it permutes bits
        within every chunk), so it pushes down to the leaves for free."""
        return _map_leaves(self, lambda ct: ct.apply_permutation(p))

    # -- accounting -----------------------------------------------------------

    @property
    def nbytes_materialized(self) -> int:
        """Payload bytes the materialized result would occupy (× fleet size
        for batch-leaf DAGs)."""
        ctx = self._any_leaf().ctx
        return ctx.chunk_count_bytes(self.chunks) * (self.batch or 1)

    def leaves(self) -> "list[Ciphertext | CiphertextBatch]":
        """Distinct leaf ciphertexts/batches (by identity), post-order."""
        return collect_leaves([self])

    def _any_leaf(self) -> "Ciphertext | CiphertextBatch":
        node = self
        while node.op != "leaf":
            node = node.args[0]
        assert node.ct is not None
        return node.ct

    # -- evaluation -----------------------------------------------------------

    def fold(self, leaf_fn) -> int:
        """Evaluate the DAG in F2 with ``leaf_fn(ct) -> int | bit-vector``
        at the leaves (add = xor, mul = and), memoized on node identity.
        Fleet DAGs return a `pack_fleet_bits`-packed int (instance i at bit i);
        see `fold_many` for the representation contract."""
        return fold_many([self], leaf_fn)[0]

    def materialize(self) -> "Ciphertext | CiphertextBatch":
        """Fold the DAG into a real Ciphertext (or `CiphertextBatch` for an
        all-batch-leaf DAG) — the public, growth-paying evaluation;
        bit-exact to applying the operators directly.

        A fleet DAG that also has scalar leaves (e.g. a netlist's public
        NOT-constant) is FOLD-ONLY: the batched operators have no
        scalar-broadcast form, so materializing would need B copies of every
        scalar leaf — decrypt it key-side instead (`decrypt_circuit`).
        """
        if self.batch is not None and any(
            isinstance(ct, Ciphertext) for ct in self.leaves()
        ):
            raise ValueError(
                "cannot materialize a fleet DAG with scalar leaves (the fold "
                "broadcasts them, ciphertext ops cannot); use "
                "SecretKey.decrypt_circuit, or lift B copies of the scalar"
            )
        memo: dict[int, Ciphertext] = {}
        for node in _postorder(self):
            if node.op == "leaf":
                memo[id(node)] = node.ct  # type: ignore[assignment]
            elif node.op == "add":
                memo[id(node)] = memo[id(node.args[0])] + memo[id(node.args[1])]
            else:
                memo[id(node)] = memo[id(node.args[0])] * memo[id(node.args[1])]
        return memo[id(self)]

    def __repr__(self) -> str:
        return f"CtExpr(op={self.op}, chunks={self.chunks}, leaves={len(self.leaves())})"


def collect_leaves(exprs: "list[CtExpr]") -> "list[Ciphertext | CiphertextBatch]":
    """Distinct leaf ciphertexts/batches (by identity) across MANY DAGs,
    post-order.

    Shares one visited set across roots, so multi-output circuits pay one
    walk total instead of one per output (per-root `leaves()` on a 128-output
    published-size netlist re-walks the shared interior 128 times).
    """
    out: "list[Ciphertext | CiphertextBatch]" = []
    seen: set[int] = set()
    visited: set[int] = set()
    for root in exprs:
        for node in _postorder(root, visited):
            if node.op == "leaf" and id(node.ct) not in seen:
                seen.add(id(node.ct))
                out.append(node.ct)  # type: ignore[arg-type]
    return out


def fold_many(exprs: "list[CtExpr]", leaf_fn) -> list[int]:
    """Evaluate MANY DAGs with ONE shared memo (add = xor, mul = and).

    Multi-output circuits (a netlist's 128 output bits, say) share most of
    their interior nodes; per-root `fold` would re-walk the shared region
    once per output — O(outputs × gates) Python work for a published-size
    circuit.  Here every node across all roots is visited exactly once.
    Bit-exact to per-root `fold` by construction (same recurrences, same
    memoization keys).

    ``leaf_fn`` returns a 0/1 int for a scalar leaf; for a `CiphertextBatch`
    leaf it returns either a bit vector (ndarray/list, one bit per instance)
    or an already-`pack_fleet_bits`-packed int.  Fleet values fold as PACKED ints
    (instance i at bit i — one native int op per gate; see `pack_fleet_bits`), and
    scalar subtrees broadcast exactly: a scalar bit expands to 0 or the
    all-instances mask at the node where the fleet meets it.  Fleet roots
    return packed ints — `unpack_fleet_bits(v, root.batch)` recovers the vector
    (`SecretKey.decrypt_circuit(s)` does this for you).
    """
    memo: dict[int, int] = {}
    leaf_memo: dict[int, int] = {}
    masks: dict[int, int] = {}
    visited: set[int] = set()
    out: list[int] = []
    for root in exprs:
        for node in _postorder(root, visited):
            if node.op == "leaf":
                k = id(node.ct)
                if k not in leaf_memo:
                    v = leaf_fn(node.ct)
                    if isinstance(v, (np.ndarray, list, tuple)):
                        v = pack_fleet_bits(v)
                    leaf_memo[k] = int(v) if node.batch else int(v) & 1
                memo[id(node)] = leaf_memo[k]
            else:
                a0, a1 = node.args
                v0, v1 = memo[id(a0)], memo[id(a1)]
                if node.batch is not None:
                    mask = masks.get(node.batch)
                    if mask is None:
                        mask = masks[node.batch] = (1 << node.batch) - 1
                    # A scalar subtree's bit broadcasts across the fleet.
                    if a0.batch is None:
                        v0 = mask if v0 else 0
                    if a1.batch is None:
                        v1 = mask if v1 else 0
                memo[id(node)] = v0 ^ v1 if node.op == "add" else v0 & v1
        out.append(memo[id(root)])
    return out


def _postorder(root: CtExpr, visited: set[int] | None = None) -> list[CtExpr]:
    """Iterative post-order over the DAG, each node once (identity-deduped).

    A caller-supplied ``visited`` set carries dedup state ACROSS roots
    (`fold_many`): nodes already emitted for an earlier root are skipped.
    """
    out: list[CtExpr] = []
    if visited is None:
        visited = set()
    stack: list[tuple[CtExpr, bool]] = [(root, False)]
    while stack:
        node, expanded = stack.pop()
        if id(node) in visited:
            continue
        if expanded or node.op == "leaf":
            visited.add(id(node))
            out.append(node)
        else:
            stack.append((node, True))
            for a in node.args:
                if id(a) not in visited:
                    stack.append((a, False))
    return out


def _map_leaves(root: CtExpr, fn) -> CtExpr:
    memo: dict[int, CtExpr] = {}
    for node in _postorder(root):
        if node.op == "leaf":
            memo[id(node)] = lift(fn(node.ct))  # re-derives chunks/batch
        else:
            args = tuple(memo[id(a)] for a in node.args)
            memo[id(node)] = CtExpr(node.op, None, args, node.chunks, node.batch)
    return memo[id(root)]
