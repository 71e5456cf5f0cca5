"""The least work of a re-key op (a product, its rotation to a reader's key
and the decrypt under it), counted the same whatever kernels do it; the
`rekey` op counts its window's work here and `kernel.rekey_roofline` reads it.

* Bytes, `op_bytes`: the operands read once and the rotated product written
  once, W * 4 * (t1 + t2 + t1 * t2).  The product itself and the decrypt
  need no bytes of their own: a kernel could rotate each product chunk
  where it is made and match it there.
* Integer operations, `network_ops`: the Beneš network of the reader's
  plan on each product chunk, over each stage's live rows (the fewest the
  H100 can issue them in, a three-input logic op counting one): 4 per
  nonzero in-word mask word (``t = (v ^ (v << d)) & m`` is a shift and a
  LOP3, ``v ^ t ^ (t >> d)`` a shift and a LOP3), and 2 per nonzero mask
  word of a cross-word stage (one a pair of words, each a bit select of the
  two under the mask, one LOP3).  The product's ANDs and the decrypt's
  compares are left out, so the count is a lower bound.
* Peaks, `INT32_OPS_PER_S`: 132 SMs x 64 int32 lanes x 1.98 GHz (the H100
  SXM's largest SM clock) = 16.73 T int32 operations a second; the bytes'
  peak is `portbench.peaks.HBM_BYTES_PER_S`.

The least time of the window is the larger of its bytes over the bytes'
peak and its operations over the operations' peak.
"""

from __future__ import annotations

import weakref

import numpy as np

__all__ = ["INT32_OPS_PER_S", "op_bytes", "network_ops", "add_ops", "window_ops"]

INT32_OPS_PER_S = {
    "NVIDIA H100 80GB HBM3": 132 * 64 * 1.98e9,
}

# The operations of each run's window, by the run's tracer (one per run).
_WINDOW_OPS: "weakref.WeakKeyDictionary[object, float]" = weakref.WeakKeyDictionary()


def op_bytes(w: int, t1: int, t2: int) -> int:
    """Bytes an op of t1 x t2 chunks of `w` words needs: operands read once,
    the rotated product written once."""
    return 4 * w * (t1 + t2 + t1 * t2)


def network_ops(plan) -> int:
    """Integer operations a chunk of a Beneš plan's network (``masks``
    ``[stages, words]``, ``deltas``, ``rows``: the stages' live rows)."""
    ops = 0
    for mask, delta, rows in zip(np.asarray(plan.masks), plan.deltas, plan.rows):
        ops += np.count_nonzero(mask[:rows]) * (4 if delta < 32 else 2)
    return int(ops)


def add_ops(tracer, ops: float) -> None:
    """Count `ops` integer operations into the window of the run of `tracer`."""
    _WINDOW_OPS[tracer] = _WINDOW_OPS.get(tracer, 0.0) + ops


def window_ops(tracer) -> float | None:
    """The operations counted into the run's window, or None where its op
    counted none (then a reader's bound is that of the bytes alone)."""
    return _WINDOW_OPS.get(tracer) if tracer is not None else None
