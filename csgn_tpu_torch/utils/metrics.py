"""Structured per-op metrics (SURVEY.md §5 observability target).

The reference has pretty-printers and nothing else; here every operator on
the production path (`Ciphertext.__add__/__mul__`,
`SecretKey.encrypt_batch/decrypt/mul_and_decrypt`) records chunks in/out,
payload bytes moved, and wall time, queryable as structured dicts (and
renderable as a table).

Timing caveat: `seconds` is host-side wall time.  CUDA launches are
asynchronous, so for back-to-back ops this measures enqueue cost, not device
time; derived GB/s is an *upper bound on visibility*, not a roofline claim.
Device times come from CUDA events (`chip_smoke.py`).  `torch.profiler`
ranges can be layered on top via `trace()`.

Kernel-path choices (ops.dispatch) are recorded with `count()` once per
call — read them as "which route served this call".
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict

__all__ = ["OpMetrics", "op_metrics", "trace"]


@dataclasses.dataclass
class OpStats:
    calls: int = 0
    chunks_in: int = 0
    chunks_out: int = 0
    bytes_moved: int = 0
    seconds: float = 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.seconds > 0:
            d["GBps"] = self.bytes_moved / self.seconds / 1e9
        return d


class OpMetrics:
    """Accumulates per-op counters; one global instance via `op_metrics()`."""

    def __init__(self):
        self._stats: dict[str, OpStats] = defaultdict(OpStats)

    @contextlib.contextmanager
    def record(self, op: str, chunks_in: int = 0, chunks_out: int = 0, bytes_moved: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            s = self._stats[op]
            s.calls += 1
            s.chunks_in += chunks_in
            s.chunks_out += chunks_out
            s.bytes_moved += bytes_moved
            s.seconds += time.perf_counter() - t0

    def count(self, op: str, n: int = 1) -> None:
        """Bump a bare call counter (no timing) — used for trace-time events
        like dispatch path selection, which fire once per compilation."""
        self._stats[op].calls += n

    def snapshot(self) -> dict[str, dict]:
        return {k: v.as_dict() for k, v in self._stats.items()}

    def reset(self) -> None:
        self._stats.clear()

    def format_table(self) -> str:
        rows = ["op                    calls   chunks_in  chunks_out       MB    ms"]
        for op, s in sorted(self._stats.items()):
            rows.append(
                f"{op:<20} {s.calls:>6} {s.chunks_in:>11} {s.chunks_out:>11} "
                f"{s.bytes_moved/1e6:>8.2f} {s.seconds*1e3:>7.2f}"
            )
        return "\n".join(rows)


_GLOBAL = OpMetrics()


def op_metrics() -> OpMetrics:
    return _GLOBAL


@contextlib.contextmanager
def trace(name: str):
    """torch.profiler annotation passthrough (near no-op if profiling inactive)."""
    import torch

    with torch.profiler.record_function(name):
        yield
