"""Spans around the calls into the program, and the reading of the device trace.

With ``--trace 1`` a span is kept as ``(name, start, end)`` in host seconds
(`time.perf_counter`).  A span synchronizes with the device at both ends
only where the call it wraps launches device work (``sync=True``); a span
around a call that touches no device (a submit, a wait) is opened with
``sync=False``, so the traced run keeps the untraced run's load.  The window
runs under `torch.profiler` with device activity only (kernels, copies,
fills): host-side operator events would put their own cost into the window.
A marker operation on an idle device, just before the window opens, ties
the profiler's clock to the host's, so the spans tell what the host was
doing in each idle gap.  With ``--trace 0`` a span is a no-op.

The device's busy time is the union of the intervals in which any device
operation ran, clipped to the window; its device time is the sum of their
durations (both over the chips used, which is one).
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch

__all__ = ["Tracer", "Trace", "NO_SPAN", "idle_pct", "mean_ms"]

NO_SPAN = "no_span"
TOP = 10  # entries of each breakdown list


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_s: float                 # summed durations of the device operations
    device_ops: list                # [[name, seconds], ...], most first
    idle_gaps: list                 # [[span name, seconds], ...], most first
    clock_offset_s: float           # profiler clock minus host clock


class _NoSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Span:
    __slots__ = ("tracer", "name", "sync", "t0")

    def __init__(self, tracer: "Tracer", name: str, sync: bool):
        self.tracer, self.name, self.sync = tracer, name, sync

    def __enter__(self):
        if self.sync:
            self.tracer.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync:
            self.tracer.synchronize()
        self.tracer.spans.append((self.name, self.t0, time.perf_counter()))
        return False


class Tracer:
    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.spans: list[tuple[str, float, float]] = []
        self.trace: Trace | None = None
        self._prof = None
        self._marker_host = None
        self._open = self._close = None

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str, sync: bool):
        return _Span(self, name, sync) if self.enabled else _NoSpan()

    def durations(self, name: str) -> list[float]:
        return [t1 - t0 for n, t0, t1 in self.spans if n == name]

    # -- the traced window ------------------------------------------------------

    def start_profile(self) -> None:
        """Start the profiler in set-up (its own start is not the window's)."""
        if not (self.enabled and self.device.type == "cuda"):
            return
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.synchronize()
        marker = torch.empty(1, dtype=torch.int32, device=self.device)
        self._marker_host = time.perf_counter()
        marker.fill_(7)
        self.synchronize()

    def open_window(self) -> float:
        self._open = time.perf_counter()
        return self._open

    def close_window(self) -> float:
        self.synchronize()
        self._close = time.perf_counter()
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            self.trace = _read(self._prof, self._marker_host, self._open, self._close,
                               self.spans)
        return self._close


def _device_events(prof) -> list[tuple[float, float, str]]:
    """``(start, end, name)`` in seconds on the profiler's clock, of every
    device operation of the trace, by start."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda and not ev.is_user_annotation():
            out.append((ev.start_ns() * 1e-9, ev.end_ns() * 1e-9, ev.name()))
    out.sort()
    return out


def _innermost(spans, t_open: float, t_close: float) -> list[tuple[float, float, str]]:
    """The window cut into ``(start, end, name)`` segments, each owned by the
    innermost span open in it (spans nest: they come from one thread)."""
    edges = []
    for name, t0, t1 in spans:
        edges.append((t0, 1, name))
        edges.append((t1, 0, name))
    edges.sort()
    segs, stack, at = [], [], t_open
    for t, opening, name in edges:
        t = min(max(t, t_open), t_close)
        if t > at:
            segs.append((at, t, stack[-1] if stack else NO_SPAN))
            at = t
        if opening:
            stack.append(name)
        elif name in stack:
            stack.reverse()
            stack.remove(name)
            stack.reverse()
    if at < t_close:
        segs.append((at, t_close, stack[-1] if stack else NO_SPAN))
    return segs


def _read(prof, marker_host: float, t_open: float, t_close: float, spans) -> Trace:
    events = _device_events(prof)
    if not events:
        raise RuntimeError("the profiler recorded no device operation")
    offset = events[0][0] - marker_host  # the marker is the first device operation
    lo, hi = t_open + offset, t_close + offset
    by_name: dict[str, float] = collections.Counter()
    busy, device_s, idle = [], 0.0, []
    cur0 = cur1 = None
    for s, e, name in events[1:]:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        device_s += e - s
        by_name[name[:96]] += e - s
        if cur1 is None or s > cur1:
            if cur1 is not None:
                busy.append((cur0, cur1))
            cur0, cur1 = s, e
        else:
            cur1 = max(cur1, e)
    if cur1 is not None:
        busy.append((cur0, cur1))
    # Idle gaps in host time, attributed to the innermost span over them.
    at = t_open
    for s, e in busy:
        if s - offset > at:
            idle.append((at, s - offset))
        at = max(at, e - offset)
    if at < t_close:
        idle.append((at, t_close))
    gaps: dict[str, float] = collections.Counter()
    segs = _innermost(spans, t_open, t_close)
    k = 0
    for g0, g1 in idle:
        while k < len(segs) and segs[k][1] <= g0:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < g1:
            gaps[segs[j][2]] += min(g1, segs[j][1]) - max(g0, segs[j][0])
            j += 1

    def top(d):
        return [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return Trace(window_s=t_close - t_open, busy_s=sum(e - s for s, e in busy),
                 device_s=device_s, device_ops=top(by_name), idle_gaps=top(gaps),
                 clock_offset_s=offset)


def idle_pct(trace: Trace | None) -> float | None:
    """The device's idle share of the traced window, in %."""
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def mean_ms(tracer: Tracer | None, name: str) -> float | None:
    """Mean duration of the spans called `name`, in ms."""
    spans = tracer.durations(name) if tracer is not None else []
    return 1e3 * sum(spans) / len(spans) if spans else None
