"""One run of one cell: set-up, the measured window, the check, the result.

Everything is found by name from ``BENCHMARK.json`` at the checkout's root:

* the cell, ``workloads/<cell>.json``: its configuration, mix, chips, why,
  and the limit of each number its check compares (``checks``);
* the configuration, ``configs/<config>.json`` (the file ``BENCHMARK.json``
  names for it);
* the traffic mix, ``traffic/<mix>.json``, read by `generator`;
* the entry the mix drives, ``ops/<op>.py`` (a class ``Op``);
* each metric's reader, ``metrics/<metric>.py`` (a function ``read(run)``
  that returns a number, or None where it finds nothing to read).

A run reports the cell's end-to-end metrics with ``--trace 0`` and its
per-layer metrics with ``--trace 1``: those whose ``workloads`` list names
the cell, or every cell where the metric has no such list.

The program is reached only through `csgn_tpu_torch`'s public API and its
launch counters (`csgn_tpu_torch.ops._build.LAUNCHES`), imported by the op
once the run has its device.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from portbench import generator
from portbench.inputs import key_positions
from portbench.tracing import Tracer, Trace

__all__ = ["PKG", "ROOT", "manifest", "cell_files", "load", "cell_metrics", "Env", "Run",
           "open_loop", "percentile", "run_cell", "forbidden_modules", "log"]

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "csgn_tpu")  # top-level module names, whole


def log(*args) -> None:
    print("[portbench]", *args, file=sys.stderr, flush=True)


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_files(cell: str) -> dict:
    """The cell's workload, configuration and traffic, parsed."""
    workload = json.loads((PKG / "workloads" / f"{cell}.json").read_text())
    config = json.loads((PKG / "configs" / f"{workload['config']}.json").read_text())
    traffic = json.loads((PKG / "traffic" / f"{workload['traffic']}.json").read_text())
    return {"workload": workload, "config": config, "traffic": traffic}


def load(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark (names may hold dots)."""
    path = PKG / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _process_start() -> float:
    """The process's start on `time.perf_counter`'s clock (Linux /proc; else now)."""
    try:
        start_ticks = int(pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(pathlib.Path("/proc/uptime").read_text().split()[0])
        return time.perf_counter() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


PROCESS_START = _process_start()
IMPORTED = time.perf_counter()  # after torch's import


def _clocks(device: torch.device) -> str:
    """``clocks.sm, power.draw, power.limit, temperature.gpu`` of the run's card."""
    if device.type != "cuda":
        return "no card"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20, check=False)
        return " | ".join(out.stdout.strip().splitlines()) or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"


@dataclasses.dataclass
class Env:
    """What an op gets: the configuration, the mix, the run's device and seed, the key's positions, the tracer, and whether
    the check's control stands in the program's place."""

    config: dict
    traffic: dict
    device: torch.device
    seed: int
    rate: float | None
    positions: np.ndarray
    tracer: Tracer
    control: bool
    stages: list
    schedule: generator.OpenSchedule | None = None  # an open loop's requests

    def stage(self, name: str):
        return _Stage(self.stages, name)


class _Stage:
    def __init__(self, stages: list, name: str):
        self.stages, self.name = stages, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.stages.append((self.name, time.perf_counter() - self.t0))
        return False


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    device_kind: str
    setup_s: float
    window_s: float
    unit: str | None = None          # what a closed loop counts
    units: float = 0.0
    bytes_needed: float | None = None
    requests: int = 0
    latencies_s: np.ndarray | None = None
    launches: dict = dataclasses.field(default_factory=dict)
    tracer: Tracer | None = None
    trace: Trace | None = None


def percentile(values: np.ndarray, q: float) -> float:
    """Nearest-rank percentile (a missing value is +inf)."""
    v = np.sort(values)
    return float(v[max(0, math.ceil(q / 100 * len(v)) - 1)])


def _closed(op, items, seconds: float, tracer: Tracer) -> dict:
    units = bytes_needed = 0.0
    attempted = failed = 0
    ends = []
    t0 = tracer.open_window()
    while True:
        item = next(items)
        try:
            u, b, req, bad = op.run(item, len(ends))
        except Exception as exc:  # noqa: BLE001 - a failed op counts, the run goes on
            log(f"op {len(ends)} ({item}) failed: {exc!r}")
            u, b, req, bad = 0, 0, 1, 1
        units, bytes_needed = units + u, bytes_needed + b
        attempted, failed = attempted + req, failed + bad
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    t1 = tracer.close_window()
    ops = np.diff(ends, prepend=0.0)
    quarter = max(1, len(ops) // 4)
    ms = lambda v: f"{v * 1e3:.4f}"  # noqa: E731
    log(f"closed loop: {len(ops)} ops, {attempted} requests in {t1 - t0:.6f} s; op ms: p50 "
        + ms(percentile(ops, 50)) + " p95 " + ms(percentile(ops, 95)) + " max "
        + ms(float(ops.max())) + "; mean of the first quarter " + ms(float(ops[:quarter].mean()))
        + ", of the last " + ms(float(ops[-quarter:].mean())))
    return {"window_s": t1 - t0, "units": units, "bytes_needed": bytes_needed,
            "attempted": attempted, "failed": failed}


def _sleep_until(t: float) -> None:
    """Sleep to 0.2 ms before `t`, then spin: `time.sleep` overshoots."""
    left = t - time.perf_counter()
    if left > 2e-4:
        time.sleep(left - 2e-4)
    while time.perf_counter() < t:
        pass


def open_loop(op, sched: generator.OpenSchedule, tracer: Tracer) -> dict:
    """Serve the schedule's requests from one thread, and time each from its
    due time until its result is read.

    Without a batching window the server flushes whenever it is idle: it
    submits every request that is due, flushes, reads the results, and sleeps
    until the next is due.  With one (``sched.flush_every_s``) it submits each
    request at its due time and flushes at every multiple of the window after
    the window opens; a flush that runs past the next tick is followed at once
    by one of every request due by then.  After the last request is due the
    loop drains."""
    due, shape = sched.due.tolist(), sched.shape.tolist()
    every = sched.flush_every_s
    n = len(due)
    done = np.full(n, np.inf)
    submitted = np.empty(n)
    woke = []           # the first request after each wait
    sizes, flush_late = [], []
    handles = [None] * n
    failed = first = i = overruns = 0
    waited = 0.0
    tick = every if every else math.inf
    t0 = tracer.open_window()
    while first < n:
        at = min(due[i] if i < n else math.inf, tick)
        if t0 + at > time.perf_counter():
            w0 = time.perf_counter()
            with tracer.span("serve.wait", sync=False):
                _sleep_until(t0 + at)
            waited += time.perf_counter() - w0
            if i < n and at == due[i]:
                woke.append(i)
        with tracer.span("serve.submit", sync=False):
            while i < n and (now := time.perf_counter() - t0) >= due[i] and due[i] < tick:
                submitted[i] = now
                handles[i] = op.submit(shape[i], i)
                i += 1
        if every:
            if (now := time.perf_counter() - t0) < tick:
                continue
            if first == i:
                tick += every
                continue
            flush_late.append(now - tick)
        with tracer.span("serve.flush", sync=True):
            op.flush()
            for j in range(first, i):
                try:
                    op.result(handles[j])
                    done[j] = time.perf_counter() - t0
                except Exception as exc:  # noqa: BLE001 - a failed request is missing
                    failed += 1
                    if failed <= 3:
                        log(f"request {j} failed: {exc!r}")
                handles[j] = None
        sizes.append(i - first)
        first = i
        if every:
            now = time.perf_counter() - t0
            overruns += now > tick + every
            tick = max(tick + every, now)
    t1 = tracer.close_window()
    late = submitted[woke] - sched.due[woke] if woke else np.zeros(1)
    return {"window_s": t1 - t0, "latencies_s": done - sched.due, "attempted": n,
            "failed": failed, "wake_late_s": late, "submit_delay_s": submitted - sched.due,
            "flush_sizes": np.asarray(sizes), "waited_s": waited,
            "flush_late_s": np.asarray(flush_late) if flush_late else None,
            "overruns": overruns}


def _open_report(res: dict, sched: generator.OpenSchedule, seconds: float) -> None:
    lat, late, delay = res["latencies_s"], res["wake_late_s"], res["submit_delay_s"]
    ms = lambda v: f"{v * 1e3:.4f}"  # noqa: E731
    log(f"open loop: {len(lat)} requests due in {seconds} s, window {res['window_s']:.6f} s, "
        f"failed {res['failed']}")
    log("generator lateness after a wait, ms: p50 " + ms(percentile(late, 50)) + " p95 "
        + ms(percentile(late, 95)) + " max " + ms(float(late.max()))
        + f" ({len(late)} waits); submit delay ms: p50 " + ms(percentile(delay, 50))
        + " p95 " + ms(percentile(delay, 95)) + " max " + ms(float(delay.max())))
    q = [lat[(sched.due >= seconds * k / 4) & (sched.due < seconds * (k + 1) / 4 + 1e-9)]
         for k in (0, 3)]
    log("latency ms: p50 " + ms(percentile(lat, 50)) + " p95 " + ms(percentile(lat, 95))
        + " p99 " + ms(percentile(lat, 99)) + " max " + ms(float(lat.max()))
        + "; mean of the first quarter " + ms(float(q[0].mean())) + ", of the last "
        + ms(float(q[1].mean())))
    sizes = res["flush_sizes"]
    log(f"requests per flush: mean {sizes.mean():.4f} p50 {percentile(sizes, 50):.0f} "
        f"p95 {percentile(sizes, 95):.0f} max {sizes.max()} over {len(sizes)} flushes; "
        f"the loop waited {res['waited_s']:.4f} s of {res['window_s']:.4f} s")
    fl = res["flush_late_s"]
    if fl is not None:
        log(f"flush start after its tick, ms: p50 {ms(percentile(fl, 50))} p95 "
            f"{ms(percentile(fl, 95))} max {ms(float(fl.max()))}; "
            f"{res['overruns']} of {len(fl)} flushes ran past the next tick")


class _GcPauses:
    """The garbage collector's pauses while the window is open, by generation."""

    def __init__(self):
        self.pauses = {0: [], 1: [], 2: []}
        self._t0 = None

    def _callback(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.pauses[info["generation"]].append(time.perf_counter() - self._t0)

    def __enter__(self):
        gc.callbacks.append(self._callback)

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)
        return False

    def report(self) -> str:
        return "garbage collections in the window: " + "; ".join(
            f"gen {g} {len(v)}, {1e3 * sum(v):.4f} ms in all, max {1e3 * max(v, default=0):.4f} ms"
            for g, v in self.pauses.items())


def _launches() -> dict:
    from csgn_tpu_torch.ops._build import LAUNCHES

    return dict(LAUNCHES)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, device=None,
             rate: float | None = None, control: bool = False,
             traffic: dict | None = None) -> tuple[dict, list[str]]:
    """Run `cell` once; return the result line's object and the check's lines.

    `device` None is CUDA device 0.  `rate` replaces an open mix's rate (to
    find the knee), `control` puts the check's control in the program's
    place, `traffic` updates the mix's parameters (the tests' small sizes);
    no measured run uses them.
    """
    bench = manifest()
    files = cell_files(cell)
    workload, config = files["workload"], files["config"]
    traffic = {**files["traffic"], **(traffic or {})}
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    stages: list = [("python and torch import", IMPORTED - PROCESS_START),
                    ("harness", time.perf_counter() - IMPORTED)]
    tracer = Tracer(trace, device)
    env = Env(config=config, traffic=traffic, device=device, seed=seed, rate=rate,
              positions=key_positions(seed, config["n"], config["d"]), tracer=tracer,
              control=control, stages=stages)
    if traffic["loop"] == "open":
        env.schedule = generator.open_schedule(traffic, seed, seconds, rate)
    if device.type == "cuda":
        with env.stage("device init"):
            torch.cuda.set_device(device)
            torch.cuda.init()
            torch.empty(1, device=device)
    op = load("ops", traffic["op"]).Op(env)
    op.setup()
    with env.stage("warm-up"):
        op.warm()
    with env.stage("gc"):
        gc.collect()
        gc.freeze()
    with env.stage("clocks"):
        clocks_open = _clocks(device)
    if trace:
        with env.stage("profiler start"):
            tracer.synchronize()
            tracer.start_profile()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = _launches()
    pauses = _GcPauses()
    setup_s = time.perf_counter() - PROCESS_START
    with pauses:
        if traffic["loop"] == "closed":
            res = _closed(op, generator.closed_items(traffic, seed), seconds, tracer)
        else:
            res = open_loop(op, env.schedule, tracer)
    launches = {k: v - launches0.get(k, 0) for k, v in _launches().items()}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    clocks_close = _clocks(device)
    log("set-up, s: " + ", ".join(f"{n} {s:.4f}" for n, s in stages) + f"; total {setup_s:.4f}")
    log(f"clocks.sm, power.draw, power.limit, temperature.gpu: at open [{clocks_open}], "
        f"at close [{clocks_close}]")
    log(pauses.report())
    if traffic["loop"] == "open":
        _open_report(res, env.schedule, seconds)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    run = Run(device_kind=kind, setup_s=setup_s,
              window_s=res["window_s"], unit=getattr(op, "unit", None),
              units=res.get("units", 0.0), bytes_needed=res.get("bytes_needed"),
              requests=res["attempted"], latencies_s=res.get("latencies_s"),
              launches=launches, tracer=tracer, trace=tracer.trace)
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        value = load("metrics", m["name"]).read(run)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing in {cell}")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    # The check runs after the window, on the program's outputs, with the
    # program's state freed.
    t_check = time.perf_counter()
    numbers = op.check()
    limits = workload["checks"]
    if set(numbers) != set(limits):
        raise RuntimeError(f"the check read {sorted(numbers)}, the cell limits {sorted(limits)}")
    correct = all(numbers[k] <= limits[k] for k in limits) and res["failed"] == 0
    lines = [f"check {k}: {numbers[k]} (limit {limits[k]})" for k in limits]
    lines.append(f"check failed requests: {res['failed']} (limit 0)")
    log(f"check took {time.perf_counter() - t_check:.3f} s")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        t = run.trace
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        out["breakdown"] = {"device_ops": t.device_ops, "idle_gaps": t.idle_gaps}
        log(f"trace: busy {t.busy_s:.6f} s of {t.window_s:.6f} s, device time "
            f"{t.device_s:.6f} s, clock offset {t.clock_offset_s:.6f} s")
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    out["checks"]["failed"] = {"value": int(res["failed"]), "limit": 0}
    return out, lines
