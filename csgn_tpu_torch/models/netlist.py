"""Bristol-Fashion boolean netlists evaluated homomorphically.

The reference evaluates hand-written gate compositions (its tests chain
`+`/`*` by hand, reference tests/basic_operations.cpp:30-43).  This
module closes the loop to the wider MPC/FHE ecosystem: parse a circuit in
the standard *Bristol Fashion* netlist format (the format published for
AES/SHA/adder benchmark circuits), or generate one, and evaluate it over
CSGN ciphertexts three ways:

  * `eval_plain`       — F2 reference evaluation (ints), the test oracle.
  * `eval_homomorphic` — materialized ciphertext evaluation via `Gates`
                         (pays the scheme's chunk growth).
  * `eval_expr`        — growth-free `CtExpr` DAG for key-side decryption
                         (`SecretKey.decrypt_circuit`); the only viable path
                         for deep carry chains, where materialized chunk
                         counts are exponential in circuit depth.

Format (Bristol Fashion, one gate per line)::

    <n_gates> <n_wires>
    <n_input_values>  <size_0> <size_1> ...
    <n_output_values> <size_0> <size_1> ...
    2 1 <a> <b> <out> XOR|AND
    1 1 <a> <out>     INV|NOT|EQW
    1 1 <0|1> <out>   EQ          # constant assignment

Wires are numbered with circuit inputs first and circuit outputs occupying
the LAST sum(output_sizes) wires.  Bit order within a value is LSB-first
for the generators here (documented per generator).  MAND (multi-AND) is
not part of CSGN's {XOR, AND, 1} normal form and is rejected loudly.

Chunk growth is tracked per wire (`Netlist.growth`): XOR adds chunk counts,
AND multiplies, INV adds the NOT-constant's chunks — so callers can budget
HBM *before* materializing (see pipeline.mul_chain's budget guard for the
same discipline on chains).  Counts saturate at `circuit.CHUNKS_SAT` (2^63):
exact below the cap, and the cap itself already means "far beyond any HBM"
(the exact count for an AND-depth-40 circuit has ~10^24 bits and is itself
uncomputable in practice).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from csgn_tpu_torch.batch import CiphertextBatch
from csgn_tpu_torch.ciphertext import Ciphertext
from csgn_tpu_torch.circuit import CtExpr, lift, sat_add, sat_mul
from csgn_tpu_torch.models.circuits import Gates

__all__ = [
    "Netlist",
    "Gate",
    "eval_plain",
    "eval_plain_packed",
    "eval_homomorphic",
    "eval_homomorphic_batch",
    "eval_expr",
    "adder",
    "equality",
    "comparator_gt",
    "bits_from_bytes",
    "bytes_from_bits",
]


def bits_from_bytes(bs: bytes) -> list[int]:
    """Bytes -> the netlist value-bit convention used by the byte-oriented
    circuits here (`models.aes`, `models.sha256`): wire ``8*i + j`` of a
    value is bit ``j`` (LSB-first) of byte ``i``."""
    return [(b >> j) & 1 for b in bs for j in range(8)]


def bytes_from_bits(bl: Sequence[int]) -> bytes:
    """Inverse of `bits_from_bytes` (accepts ints or Plaintext-like)."""
    if len(bl) % 8:
        raise ValueError(f"bit count {len(bl)} is not a whole number of bytes")
    return bytes(
        sum((int(bl[8 * i + j]) & 1) << j for j in range(8))
        for i in range(len(bl) // 8)
    )

_BINARY = ("XOR", "AND")
_UNARY = ("INV", "NOT", "EQW")


@dataclasses.dataclass(frozen=True)
class Gate:
    """One netlist gate: ``op`` ∈ {XOR, AND, INV, NOT, EQW, EQ}.

    For EQ, ``ins[0]`` is the constant bit (0 or 1), not a wire id.
    """

    op: str
    ins: tuple[int, ...]
    out: int


@dataclasses.dataclass(frozen=True)
class Netlist:
    """A parsed Bristol-Fashion circuit (validated at construction)."""

    n_wires: int
    input_sizes: tuple[int, ...]
    output_sizes: tuple[int, ...]
    gates: tuple[Gate, ...]

    def __post_init__(self):
        n_in = sum(self.input_sizes)
        n_out = sum(self.output_sizes)
        if n_in + n_out > self.n_wires:
            raise ValueError(
                f"{self.n_wires} wires cannot hold {n_in} inputs + {n_out} outputs"
            )
        assigned = set()
        for g in self.gates:
            if g.op in _BINARY:
                if len(g.ins) != 2:
                    raise ValueError(f"{g.op} takes 2 inputs, got {g.ins}")
            elif g.op in _UNARY:
                if len(g.ins) != 1:
                    raise ValueError(f"{g.op} takes 1 input, got {g.ins}")
            elif g.op == "EQ":
                if len(g.ins) != 1 or g.ins[0] not in (0, 1):
                    raise ValueError(f"EQ takes one constant bit, got {g.ins}")
            elif g.op == "MAND":
                raise ValueError(
                    "MAND (multi-AND) is not supported: CSGN's gate basis is "
                    "{XOR, AND, 1}; expand MAND into 2-input ANDs"
                )
            else:
                raise ValueError(f"unknown gate type {g.op!r}")
            wire_ins = g.ins if g.op != "EQ" else ()
            for w in wire_ins + (g.out,):
                if not 0 <= w < self.n_wires:
                    raise ValueError(f"wire {w} out of range [0, {self.n_wires})")
            for w in wire_ins:
                if w >= n_in and w not in assigned:
                    raise ValueError(f"gate reads wire {w} before any gate drives it")
            if g.out < n_in:
                raise ValueError(f"gate drives input wire {g.out}")
            if g.out in assigned:
                raise ValueError(f"wire {g.out} driven twice")
            assigned.add(g.out)
        for w in range(self.n_wires - n_out, self.n_wires):
            if w not in assigned and w >= n_in:
                raise ValueError(f"output wire {w} is never driven")

    def __hash__(self) -> int:
        """Cached: serving executors key request groups by netlist, and the
        dataclass-generated hash walks every Gate on every submit (O(gates)
        per request for published-size circuits)."""
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash((self.n_wires, self.input_sizes, self.output_sizes, self.gates))
            object.__setattr__(self, "_hash", h)
        return h

    # -- derived ---------------------------------------------------------------

    @property
    def n_inputs(self) -> int:
        return sum(self.input_sizes)

    @property
    def n_outputs(self) -> int:
        return sum(self.output_sizes)

    @property
    def and_count(self) -> int:
        """Number of AND gates — what the scheme's growth (and cost) scale with."""
        return sum(1 for g in self.gates if g.op == "AND")

    def growth(
        self, input_chunks: Sequence[int] | int = 1, one_chunks: int = 1
    ) -> list[int]:
        """Worst-case materialized chunk count of each output wire.

        XOR concatenates (t1+t2), AND cross-multiplies (t1*t2), INV XORs a
        ``one_chunks``-chunk constant, EQ costs 1 (const 1) or 2·one
        (const 0 = one+one).  Mirrors reference growth semantics
        (src/Ciphertext.cpp:107-163).  Values saturate at
        `circuit.CHUNKS_SAT` (2^63) — exact below the cap; see the module
        docstring.
        """
        chunks = self._wire_chunks(input_chunks, one_chunks)
        return [chunks[w] for w in range(self.n_wires - self.n_outputs, self.n_wires)]

    def peak_chunks(
        self, input_chunks: Sequence[int] | int = 1, one_chunks: int = 1
    ) -> int:
        """Largest chunk count any single wire materializes to (saturating).

        A lower bound on peak live memory for `eval_homomorphic`; the
        budget guards use it to reject deep circuits BEFORE the first
        superlinear multiply allocates (same discipline as
        pipeline.mul_chain's closed-form check).
        """
        return max(self._wire_chunks(input_chunks, one_chunks).values(), default=0)

    def _wire_chunks(
        self, input_chunks: Sequence[int] | int, one_chunks: int
    ) -> dict[int, int]:
        """Chunk count of EVERY wire (the one interpreter behind `growth`
        and `peak_chunks` — the accounting rules live only here)."""
        if isinstance(input_chunks, int):
            input_chunks = [input_chunks] * self.n_inputs
        if len(input_chunks) != self.n_inputs:
            raise ValueError(
                f"need {self.n_inputs} input chunk counts, got {len(input_chunks)}"
            )
        chunks: dict[int, int] = {i: int(c) for i, c in enumerate(input_chunks)}
        for g in self.gates:
            if g.op == "XOR":
                chunks[g.out] = sat_add(chunks[g.ins[0]], chunks[g.ins[1]])
            elif g.op == "AND":
                chunks[g.out] = sat_mul(chunks[g.ins[0]], chunks[g.ins[1]])
            elif g.op in ("INV", "NOT"):
                chunks[g.out] = sat_add(chunks[g.ins[0]], one_chunks)
            elif g.op == "EQW":
                chunks[g.out] = chunks[g.ins[0]]
            else:  # EQ
                chunks[g.out] = one_chunks if g.ins[0] else 2 * one_chunks
        return chunks

    # -- (de)serialization -------------------------------------------------------

    @classmethod
    def parse(cls, text: str, *, expand_mand: bool = False) -> "Netlist":
        """Parse Bristol-Fashion text (blank lines ignored).

        ``expand_mand=True`` accepts the EXTENDED format's multi-output MAND
        lines (the published AES-class circuits use them: 2k inputs, k
        outputs, out_j = in_j AND in_{k+j}) by expanding each into k 2-input
        AND gates — gate count grows, wire numbering is unchanged.  The
        default rejects MAND loudly: CSGN's basis is {XOR, AND, 1}, and a
        caller should opt into the rewrite explicitly.
        """
        lines = [ln.split() for ln in text.splitlines() if ln.strip()]
        if len(lines) < 3:
            raise ValueError("netlist needs header (3 lines) + gates")
        n_gates, n_wires = int(lines[0][0]), int(lines[0][1])
        in_hdr, out_hdr = lines[1], lines[2]
        input_sizes = tuple(int(x) for x in in_hdr[1 : 1 + int(in_hdr[0])])
        output_sizes = tuple(int(x) for x in out_hdr[1 : 1 + int(out_hdr[0])])
        if len(input_sizes) != int(in_hdr[0]) or len(output_sizes) != int(out_hdr[0]):
            raise ValueError("input/output header count mismatch")
        gates = []
        seen_lines = 0
        for ln in lines[3:]:
            seen_lines += 1
            n_in, n_out_cnt, op = int(ln[0]), int(ln[1]), ln[-1]
            if op == "MAND" and expand_mand:
                # Handles k = 1 too (a degenerate single-output MAND line is
                # a plain AND in the extended format).
                if n_in != 2 * n_out_cnt:
                    raise ValueError(
                        f"MAND needs 2x as many inputs as outputs: {' '.join(ln)}"
                    )
                ins = [int(x) for x in ln[2 : 2 + n_in]]
                outs = [int(x) for x in ln[2 + n_in : 2 + n_in + n_out_cnt]]
                for j in range(n_out_cnt):
                    gates.append(
                        Gate(op="AND", ins=(ins[j], ins[n_out_cnt + j]), out=outs[j])
                    )
                continue
            if n_out_cnt != 1:
                if op == "MAND":
                    # Extended Bristol Fashion packs k parallel ANDs into one
                    # multi-output line; CSGN's basis is {XOR, AND, 1} — opt
                    # into the rewrite with parse(..., expand_mand=True).
                    raise ValueError(
                        f"MAND (multi-output multi-AND) is not supported "
                        f"(pass expand_mand=True to rewrite into 2-input "
                        f"ANDs): {' '.join(ln)}"
                    )
                raise ValueError(f"multi-output gates unsupported: {' '.join(ln)}")
            out_w = int(ln[-1 - n_out_cnt])
            ins = tuple(int(x) for x in ln[2 : 2 + n_in])
            gates.append(Gate(op=op, ins=ins, out=out_w))
        if seen_lines != n_gates:
            raise ValueError(f"header says {n_gates} gates, found {seen_lines}")
        return cls(n_wires, input_sizes, output_sizes, tuple(gates))

    def to_text(self) -> str:
        """Serialize back to Bristol-Fashion text (parse-roundtrip exact)."""
        out = [
            f"{len(self.gates)} {self.n_wires}",
            f"{len(self.input_sizes)} " + " ".join(map(str, self.input_sizes)),
            f"{len(self.output_sizes)} " + " ".join(map(str, self.output_sizes)),
        ]
        for g in self.gates:
            ins = " ".join(map(str, g.ins))
            out.append(f"{len(g.ins)} 1 {ins} {g.out} {g.op}")
        return "\n".join(out) + "\n"

    def __repr__(self) -> str:
        return (
            f"Netlist(gates={len(self.gates)}, wires={self.n_wires}, "
            f"in={self.input_sizes}, out={self.output_sizes}, ands={self.and_count})"
        )


# -- evaluation ----------------------------------------------------------------


def _flatten_inputs(netlist: Netlist, inputs: Sequence[Sequence]) -> list:
    if len(inputs) != len(netlist.input_sizes):
        raise ValueError(
            f"need {len(netlist.input_sizes)} input values, got {len(inputs)}"
        )
    flat = []
    for val, size in zip(inputs, netlist.input_sizes):
        if len(val) != size:
            raise ValueError(f"input value has {len(val)} bits, header says {size}")
        flat.extend(val)
    return flat


def _unflatten_outputs(netlist: Netlist, wires: dict[int, object]) -> list[list]:
    out, w = [], netlist.n_wires - netlist.n_outputs
    for size in netlist.output_sizes:
        out.append([wires[w + i] for i in range(size)])
        w += size
    return out


def eval_plain(netlist: Netlist, inputs: Sequence[Sequence[int]]) -> list[list[int]]:
    """Reference F2 evaluation on plain bits — the oracle for the two below."""
    wires: dict[int, int] = {
        i: int(b) & 1 for i, b in enumerate(_flatten_inputs(netlist, inputs))
    }
    for g in netlist.gates:
        if g.op == "XOR":
            wires[g.out] = wires[g.ins[0]] ^ wires[g.ins[1]]
        elif g.op == "AND":
            wires[g.out] = wires[g.ins[0]] & wires[g.ins[1]]
        elif g.op in ("INV", "NOT"):
            wires[g.out] = wires[g.ins[0]] ^ 1
        elif g.op == "EQW":
            wires[g.out] = wires[g.ins[0]]
        else:  # EQ
            wires[g.out] = g.ins[0]
    return _unflatten_outputs(netlist, wires)


def eval_plain_packed(
    netlist: Netlist, inputs: Sequence[Sequence[int]], b: int
) -> list[list[int]]:
    """`eval_plain` over B instances at once on `circuit.pack_fleet_bits`-packed
    ints (instance i at bit i) — ONE native int op per gate for the whole
    fleet.

    This is the key-side fleet readout: decrypting a netlist's CtExpr DAG
    folds to exactly this evaluation over the decrypted input bits (Dec is
    a ring homomorphism, reference src/SecretKey.cpp:126-146), so a
    key-holding server (`BatchExecutor.submit_netlist_expr`) can skip
    building the DAG entirely.  Outputs are packed; unpack with
    `circuit.unpack_fleet_bits(v, b)`.
    """
    mask = (1 << b) - 1
    flat = _flatten_inputs(netlist, inputs)
    wires: dict[int, int] = {i: int(v) & mask for i, v in enumerate(flat)}
    for g in netlist.gates:
        if g.op == "XOR":
            wires[g.out] = wires[g.ins[0]] ^ wires[g.ins[1]]
        elif g.op == "AND":
            wires[g.out] = wires[g.ins[0]] & wires[g.ins[1]]
        elif g.op in ("INV", "NOT"):
            wires[g.out] = wires[g.ins[0]] ^ mask
        elif g.op == "EQW":
            wires[g.out] = wires[g.ins[0]]
        else:  # EQ
            wires[g.out] = mask if g.ins[0] else 0
    return _unflatten_outputs(netlist, wires)


def _check_netlist_budget(
    netlist: Netlist, flat_inputs, one: Ciphertext, b: int, budget_bytes
) -> None:
    """Reject materialization that cannot fit BEFORE the first superlinear
    multiply allocates (pipeline.mul_chain's budget discipline)."""
    if budget_bytes is None:
        return
    peak = netlist.peak_chunks([ct.chunks for ct in flat_inputs], one.chunks)
    need = one.ctx.chunk_count_bytes(peak) * b
    if need > budget_bytes:
        raise ValueError(
            f"materialized evaluation peaks at >= {need / 2**30:.2f} GiB "
            f"({peak} chunks on one wire x batch {b}) > budget "
            f"{budget_bytes / 2**30:.2f} GiB; deep circuits are growth-free "
            "via eval_expr + SecretKey.decrypt_circuit(s) (or the executor's "
            "submit_netlist_expr).  Raise or disable the budget with "
            "budget_bytes=... (None to override), or, when serving, with "
            "BatchExecutor(netlist_budget_bytes=...)."
        )


def eval_homomorphic(
    netlist: Netlist,
    inputs: Sequence[Sequence[Ciphertext]],
    gates: Gates,
    *,
    budget_bytes: "int | None" = None,
) -> list[list[Ciphertext]]:
    """Materialized ciphertext evaluation (public; pays chunk growth).

    ``budget_bytes`` (opt-in here; the serving executor passes its
    `netlist_budget_bytes`) rejects circuits whose growth cannot fit before anything
    allocates.  For key-side decryption of deep circuits use `eval_expr`
    instead.
    """
    flat = _flatten_inputs(netlist, inputs)
    _check_netlist_budget(netlist, flat, gates.one, 1, budget_bytes)
    wires: dict[int, Ciphertext] = dict(enumerate(flat))
    for g in netlist.gates:
        if g.op == "XOR":
            wires[g.out] = wires[g.ins[0]] + wires[g.ins[1]]
        elif g.op == "AND":
            wires[g.out] = wires[g.ins[0]] * wires[g.ins[1]]
        elif g.op in ("INV", "NOT"):
            wires[g.out] = gates.not_(wires[g.ins[0]])
        elif g.op == "EQW":
            wires[g.out] = wires[g.ins[0]]
        else:  # EQ: 1 -> one, 0 -> one+one (a public encryption of 0)
            wires[g.out] = gates.one if g.ins[0] else gates.one + gates.one
    return _unflatten_outputs(netlist, wires)


def eval_homomorphic_batch(
    netlist: Netlist,
    inputs: Sequence[Sequence[CiphertextBatch]],
    one: Ciphertext,
    *,
    budget_bytes: "int | None" = None,
) -> list[list[CiphertextBatch]]:
    """Evaluate ONE circuit over B independent input sets in parallel.

    Each input wire is a `CiphertextBatch` holding that wire's ciphertext for
    all B instances; every gate then runs ONCE as a batched dispatch on the
    whole fleet ([B, W, C] kernels), so evaluating a circuit over B inputs
    costs O(gates) launches instead of O(B * gates) — the batched shape of
    the reference's per-request gate chaining
    (reference tests/basic_operations.cpp:30-43).  Bit-equal per
    element to `eval_homomorphic`.

    ``one`` is a public encryption of 1 (shared across the fleet — NOT
    gates XOR the same constant into every element, which is semantically
    fine: re-randomization is the caller's concern, as with `Gates.one`).
    """
    flat = _flatten_inputs(netlist, inputs)
    b = None
    for cb in flat:
        if not isinstance(cb, CiphertextBatch):
            raise TypeError(
                f"batched evaluation expects CiphertextBatch wires, got {type(cb).__name__}"
            )
        if cb.ctx != one.ctx:
            raise ValueError("input batch context differs from the NOT-constant's")
        if b is None:
            b = cb.batch
        elif cb.batch != b:
            raise ValueError(f"batch mismatch across wires: {cb.batch} vs {b}")
    if b is None:
        raise ValueError("circuit has no inputs")
    _check_netlist_budget(netlist, flat, one, b, budget_bytes)
    ow = one.canonical().wt
    one_b = CiphertextBatch(ow[None].expand(b, *ow.shape).contiguous(), one.ctx)

    wires: dict[int, CiphertextBatch] = dict(enumerate(flat))
    for g in netlist.gates:
        if g.op == "XOR":
            wires[g.out] = wires[g.ins[0]] + wires[g.ins[1]]
        elif g.op == "AND":
            wires[g.out] = wires[g.ins[0]] * wires[g.ins[1]]
        elif g.op in ("INV", "NOT"):
            wires[g.out] = wires[g.ins[0]] + one_b
        elif g.op == "EQW":
            wires[g.out] = wires[g.ins[0]]
        else:  # EQ: 1 -> one, 0 -> one+one (a public encryption of 0)
            wires[g.out] = one_b if g.ins[0] else one_b + one_b
    return _unflatten_outputs(netlist, wires)


def eval_expr(
    netlist: Netlist,
    inputs: Sequence[Sequence[Ciphertext | CtExpr]],
    one: Ciphertext,
) -> list[list[CtExpr]]:
    """Growth-free evaluation to `CtExpr` DAGs for `SecretKey.decrypt_circuit`.

    No device work happens here; each output is a +/* DAG over the input
    leaves (shared subcircuits stay shared), decryptable in O(sum of leaf
    chunks) regardless of depth — the key-side path for circuits whose
    materialized growth (`netlist.growth()`) exceeds HBM.

    Wires may also be `CiphertextBatch`es (all with the same B): the ONE
    resulting DAG serves the whole fleet — `decrypt_circuit(s)` folds it
    once with uint8[B] leaf vectors instead of B scalar walks, which is the
    only fleet path for deep circuits (`eval_homomorphic_batch` would
    materialize the growth).
    """
    one_e = lift(one)
    wires: dict[int, CtExpr] = {
        i: lift(v) for i, v in enumerate(_flatten_inputs(netlist, inputs))
    }
    for g in netlist.gates:
        if g.op == "XOR":
            wires[g.out] = wires[g.ins[0]] + wires[g.ins[1]]
        elif g.op == "AND":
            wires[g.out] = wires[g.ins[0]] * wires[g.ins[1]]
        elif g.op in ("INV", "NOT"):
            wires[g.out] = wires[g.ins[0]] + one_e
        elif g.op == "EQW":
            wires[g.out] = wires[g.ins[0]]
        else:  # EQ
            wires[g.out] = one_e if g.ins[0] else one_e + one_e
    return _unflatten_outputs(netlist, wires)


# -- generators ------------------------------------------------------------------


class _Builder:
    """Accumulates gates on scratch wires, then renumbers so circuit outputs
    land on the final wires (the Bristol-Fashion contract)."""

    def __init__(self, input_sizes: Sequence[int]):
        self.input_sizes = tuple(input_sizes)
        self.next = sum(input_sizes)
        self.gates: list[Gate] = []

    def emit(self, op: str, *ins: int) -> int:
        out = self.next
        self.next += 1
        self.gates.append(Gate(op=op, ins=tuple(ins), out=out))
        return out

    def xor(self, a: int, b: int) -> int:
        return self.emit("XOR", a, b)

    def and_(self, a: int, b: int) -> int:
        return self.emit("AND", a, b)

    def inv(self, a: int) -> int:
        return self.emit("INV", a)

    def xor_tree(self, ws: Sequence[int]) -> int:
        """Left fold of XOR over ``ws`` (at least one wire)."""
        acc = ws[0]
        for w in ws[1:]:
            acc = self.xor(acc, w)
        return acc

    def finish(self, outputs: Sequence[int], output_sizes: Sequence[int]) -> Netlist:
        if len(outputs) != sum(output_sizes):
            raise ValueError("output wire count != sum(output_sizes)")
        # Route each output through an EQW copy onto the final wire block.
        n_wires = self.next + len(outputs)
        for i, w in enumerate(outputs):
            self.gates.append(Gate(op="EQW", ins=(w,), out=self.next + i))
        return Netlist(n_wires, self.input_sizes, tuple(output_sizes), tuple(self.gates))


def adder(width: int) -> Netlist:
    """Ripple-carry adder: two LSB-first ``width``-bit values → ``width+1``
    bits (sum, carry-out last).  AND-depth = width, so the materialized
    growth of the top bits is exponential — built for `eval_expr`."""
    b = _Builder([width, width])
    a0, b0 = 0, width
    outs: list[int] = []
    carry = None
    for i in range(width):
        x, y = a0 + i, b0 + i
        axy = b.xor(x, y)
        if carry is None:
            outs.append(axy)
            carry = b.and_(x, y)
        else:
            outs.append(b.xor(axy, carry))
            carry = b.xor(b.and_(x, y), b.and_(carry, axy))
    outs.append(carry)
    return b.finish(outs, [width + 1])


def equality(width: int) -> Netlist:
    """LSB-first ``width``-bit equality: one output bit, a == b."""
    b = _Builder([width, width])
    acc = None
    for i in range(width):
        eq = b.inv(b.xor(i, width + i))
        acc = eq if acc is None else b.and_(acc, eq)
    return b.finish([acc], [1])


def comparator_gt(width: int) -> Netlist:
    """Unsigned a > b (LSB-first inputs), one output bit.

    LSB-up recurrence: gt_{0..i} = (a_i & ~b_i) | (eq_i & gt_{0..i-1}) —
    a higher bit wins outright, equal bits defer to the lower slice; | is
    expanded into the {XOR, AND} basis (x|y = x^y^(x&y))."""
    b = _Builder([width, width])
    gt = None
    for i in range(width):
        x, y = i, width + i
        a_and_notb = b.and_(x, b.inv(y))
        if gt is None:
            gt = a_and_notb
        else:
            eq = b.inv(b.xor(x, y))
            t = b.and_(eq, gt)
            # a_and_notb and t are mutually exclusive, but keep the general
            # OR expansion for clarity of the basis translation.
            gt = b.xor(b.xor(a_and_notb, t), b.and_(a_and_notb, t))
    return b.finish([gt], [1])
