"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``) and a
seed in, the requests of a run out.

A mix holds:

* ``op``: the entry the requests drive (the file ``ops/<op>.py``);
* ``loop``: ``"closed"`` (one client sends its next job when the last one
  has ended) or ``"open"`` (independent users send on a schedule, whether or
  not earlier requests are done);
* ``shapes``: the sizes of the jobs, one list of numbers each, which the op
  reads (chunk counts, a fleet size);
* closed loops: ``sets``, how many distinct operand sets each shape has;
* open loops: ``rate_per_s`` and ``arrivals`` (``"poisson"``), and
  optionally ``bursts``: ``{"period_s", "on_share", "factor"}``, where for
  the first ``on_share`` of every period requests come ``factor`` times as
  fast as the mean rate and the rest of the period is slower to keep that
  mean; and optionally ``flush_every_s``, the server's batching window: it
  flushes at every multiple of it after the window opens, and not whenever
  it is idle (see `portbench.harness.open_loop`).

Every seed gets the same work in its own order.  A closed loop runs every
(shape, set) pair once a cycle, each cycle in an order drawn from the seed.
An open loop of N requests over ``seconds`` has each shape N / len(shapes)
times and, as its gaps, the N exponential quantiles scaled to ``seconds``,
both shuffled by the seed; the last request is due at the window's end.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator

import numpy as np

from portbench.inputs import host_rng

__all__ = ["closed_items", "OpenSchedule", "open_schedule"]


def closed_items(traffic: dict, seed: int) -> Iterator[tuple[int, int]]:
    """``(shape index, set index)`` forever, cycle by cycle."""
    pairs = list(itertools.product(range(len(traffic["shapes"])), range(traffic["sets"])))
    rng = host_rng(seed, "closed-order")
    while True:
        for k in rng.permutation(len(pairs)):
            yield pairs[k]


@dataclasses.dataclass(frozen=True)
class OpenSchedule:
    due: np.ndarray     # float64[N], seconds after the window opens, ascending
    shape: np.ndarray   # int64[N], index into the mix's shapes
    flush_every_s: float | None = None  # the batching window; None: flush when idle


def _bursty(t: np.ndarray, seconds: float, bursts: dict) -> np.ndarray:
    """Map times of a steady schedule through the inverse of the cumulative
    arrival intensity of an on/off profile with the same mean."""
    period, share, factor = bursts["period_s"], bursts["on_share"], bursts["factor"]
    off = (1.0 - share * factor) / (1.0 - share)
    if not 0.0 < share < 1.0 or factor < 1.0 or off < 0.0:
        raise ValueError(f"bursts {bursts}: need 0 < on_share < 1, factor >= 1, "
                         "on_share * factor <= 1")
    on_len = share * period
    full, rest = np.divmod(t, period)  # steady time: one period holds `period` of it
    on_mass = on_len * factor
    inside = np.where(rest < on_mass, rest / factor,
                      on_len + (rest - on_mass) / off if off > 0 else on_len)
    return np.minimum(full * period + inside, seconds)


def open_schedule(traffic: dict, seed: int, seconds: float,
                  rate: float | None = None) -> OpenSchedule:
    if traffic.get("arrivals") != "poisson":
        raise ValueError(f"unknown arrival law {traffic.get('arrivals')!r}")
    rate = float(traffic["rate_per_s"] if rate is None else rate)
    kinds = len(traffic["shapes"])
    n = max(1, round(rate * seconds / kinds)) * kinds
    rng = host_rng(seed, "open")
    shape = rng.permutation(np.repeat(np.arange(kinds), n // kinds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = rng.permutation(gaps * (seconds / gaps.sum()))
    due = np.cumsum(gaps)
    if "bursts" in traffic:
        due = _bursty(due, seconds, traffic["bursts"])
    return OpenSchedule(due=due, shape=shape, flush_every_s=traffic.get("flush_every_s"))
