"""Per-op counts and host spans: one recorder for the port (SURVEY.md §5
observability target).

**Counts**, always on.  Every operator on the production path
(`Ciphertext.__add__/__mul__`, `SecretKey.encrypt_batch/decrypt/
mul_and_decrypt`, the batched and sharded forms, the executor's groups)
records its calls, chunks in/out and payload bytes with `record()`.  Route
choices are bare counters (`count()`, once per call): ``dispatch.<op>.<cuda|
plain>`` (`ops.dispatch`), ``<wrapper>.<mode>`` (the multiply's modes,
`ops.kernels`), ``<wrapper>.<path>`` (the Beneš kernels' paths, ``register``,
``lanes``, ``wide`` or ``global``, `ops.benes_kernels`) and
``key.upload.<async|blocking>`` (a `SecretKey`'s build: one non-blocking
copy from pinned memory on a CUDA device, plain copies elsewhere) — read
them as "which route served this call".

**Spans**, off by default.  With recording on (`enable()` / `disable()`, or
the `recording()` context), `span(name)` keeps, for the block it wraps, the
name, its start and end on `clock`, the index of the span open around it
(one thread: a stack), an ``id`` shared by the spans of one request or
flush (given, or else the parent's), and a few attributes.  `record()`
opens a span of the op's name, and the op's ``seconds`` is then the sum of
those spans.  With recording off, `span()` returns one shared no-op and
`record()` only counts: no clock is read.

Every span is host time.  CUDA launches are asynchronous, so a span around a
launch measures its enqueue, and a span around a read of a device value
(``key.readback``, ``executor.readback``) the wait for the device plus the
copy.  Device times come from CUDA events or a profiler trace; `clock` is
`time.perf_counter`, to which a trace's clock can be tied by a marker
operation (portbench/tracing.py does so).

The program's spans:

  * serving (`serve.BatchExecutor`): ``executor.submit`` (id: the request's
    number), ``executor.flush`` (id: the flush's number, inherited by
    everything under it), per group ``serve.<kind>`` (its ``chunks_in`` is
    the group's request count) over ``executor.stack``,
    ``executor.readback`` and ``executor.unpack`` (wrappers and futures);
  * API: the `record()` names (``key.*``, ``ct.*``, ``batch.*``,
    ``sharded.*``), ``key.readback`` around the ``int(parity)`` of
    `SecretKey.decrypt`, `SecretKey.mul_and_decrypt` and
    `SecretKey.permute_and_decrypt`, ``key.apply_permutation`` around the
    rotated key's build in `SecretKey.permute_and_decrypt` (before its op
    span; on a CUDA device its upload is enqueued, not waited for), and
    ``perm.plan`` around a Beneš plan's build in
    `Permutation.benes_plan` (a cache miss, also counted as
    ``perm.plan_builds``), ``perm.stack_plans`` around the stack of a
    fleet's plans and its masks' upload in
    `CiphertextBatch.apply_permutations`, and the counter
    ``perm.plan_upload_bytes`` (one call a plan's or stack's copy to a
    device, a cache miss of `permute_benes.device_operands`; its
    ``bytes_moved`` the masks' and schedule's bytes);
  * kernels: ``launch.<wrapper>`` around each wrapper's CUDA body (mode
    choice, output allocation, the ctypes launch, the ``LAUNCHES`` count).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from collections import defaultdict
from typing import NamedTuple

__all__ = ["OpMetrics", "Span", "clock", "op_metrics", "self_times"]

clock = time.perf_counter  # the clock of every span


@dataclasses.dataclass
class OpStats:
    calls: int = 0
    chunks_in: int = 0
    chunks_out: int = 0
    bytes_moved: int = 0
    seconds: float = 0.0  # summed host time of the op's spans (recording on only)


class Span(NamedTuple):
    """One recorded span; ``end`` is nan while it is open."""

    name: str
    start: float
    end: float
    parent: int          # index of the enclosing span, -1 at the top
    id: int | None
    attrs: dict | None

    @property
    def seconds(self) -> float:
        return self.end - self.start


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("_rec", "_name", "_id", "_attrs", "_stats", "_index", "_era", "_t0")

    def __init__(self, rec: "OpMetrics", name: str, id: int | None, attrs: dict | None,
                 stats: OpStats | None):
        self._rec, self._name, self._id, self._attrs, self._stats = rec, name, id, attrs, stats

    def __enter__(self):
        rec = self._rec
        parent = rec._open[-1] if rec._open else -1
        self._index = len(rec._names)
        self._era = rec._era
        rec._names.append(self._name)
        rec._parents.append(parent)
        rec._ids.append(self._id if self._id is not None or parent < 0 else rec._ids[parent])
        rec._attrs.append(self._attrs)
        rec._ends.append(math.nan)
        rec._open.append(self._index)
        self._t0 = clock()
        rec._starts.append(self._t0)
        return self

    def __exit__(self, *exc):
        t = clock()
        rec = self._rec
        if self._era == rec._era:  # not reset while open
            rec._ends[self._index] = t
            rec._open.pop()
        if self._stats is not None:
            self._stats.seconds += t - self._t0
        return False


class OpMetrics:
    """Counts per op and, while recording, spans; one global instance via
    `op_metrics()`.  Spans are kept column by column, in lists of strings,
    numbers and small dicts of numbers, none of which the garbage collector
    tracks, so a long recording adds nothing to its walks."""

    def __init__(self):
        self._stats: dict[str, OpStats] = defaultdict(OpStats)
        self._on = False
        self._era = 0
        self._names: list[str] = []
        self._starts: list[float] = []
        self._ends: list[float] = []
        self._parents: list[int] = []
        self._ids: list = []
        self._attrs: list = []
        self._open: list[int] = []

    # -- the switch ---------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._on

    def enable(self) -> None:
        self._on = True

    def disable(self) -> None:
        self._on = False

    @contextlib.contextmanager
    def recording(self):
        """Record spans inside the block, then restore the switch."""
        was, self._on = self._on, True
        try:
            yield self
        finally:
            self._on = was

    # -- spans and counts ---------------------------------------------------------

    def span(self, name: str, id: int | None = None, attrs: dict | None = None):
        """A context manager that records the block as a span ``name`` (see the
        module docstring); the shared no-op while recording is off."""
        if not self._on:
            return _NO_SPAN
        return _Span(self, name, id, attrs, None)

    def record(self, op: str, chunks_in: int = 0, chunks_out: int = 0, bytes_moved: int = 0):
        """Count one call of `op`; the returned context manager is a span of
        the op's name while recording is on (its time goes to the op's
        ``seconds``), else the shared no-op."""
        s = self._stats[op]
        s.calls += 1
        s.chunks_in += chunks_in
        s.chunks_out += chunks_out
        s.bytes_moved += bytes_moved
        if not self._on:
            return _NO_SPAN
        attrs = {"chunks_in": chunks_in, "chunks_out": chunks_out, "bytes_moved": bytes_moved}
        return _Span(self, op, None, attrs, s)

    def count(self, op: str, n: int = 1, bytes_moved: int = 0) -> None:
        """Bump a bare call counter (no span) — used for route choices, once
        per call, and for copies, whose bytes go to the op's ``bytes_moved``."""
        s = self._stats[op]
        s.calls += n
        s.bytes_moved += bytes_moved

    def spans(self) -> list[Span]:
        """Every span recorded since the last `reset()`, in the order they
        opened (``parent`` indexes this list)."""
        return [Span(*row) for row in zip(self._names, self._starts, self._ends,
                                          self._parents, self._ids, self._attrs)]

    def snapshot(self) -> dict[str, dict]:
        return {k: dataclasses.asdict(v) for k, v in self._stats.items()}

    def reset(self) -> None:
        """Clear counts and spans (the switch stays as it is)."""
        self._stats.clear()
        for col in (self._names, self._starts, self._ends, self._parents, self._ids,
                    self._attrs, self._open):
            col.clear()
        self._era += 1

    def format_table(self) -> str:
        rows = ["op                    calls   chunks_in  chunks_out       MB    ms"]
        for op, s in sorted(self._stats.items()):
            rows.append(
                f"{op:<20} {s.calls:>6} {s.chunks_in:>11} {s.chunks_out:>11} "
                f"{s.bytes_moved/1e6:>8.2f} {s.seconds*1e3:>7.2f}"
            )
        return "\n".join(rows)


def self_times(spans: list[Span]) -> list[float]:
    """Each span's own time: its duration less its children's (by the parent
    links), in seconds."""
    own = [s.seconds for s in spans]
    for s in spans:
        if s.parent >= 0:
            own[s.parent] -= s.seconds
    return own


_GLOBAL = OpMetrics()


def op_metrics() -> OpMetrics:
    return _GLOBAL
