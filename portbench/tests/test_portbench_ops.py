"""Each cell driven through the harness on the port's CPU path at small sizes:
correct on the program, not correct on the control, and not correct with
the timed path broken underneath (an answer altered where it is produced,
half of a batch left out with the rest's answers in its place)."""

import numpy as np
import pytest
import torch

from portbench import harness

SMALL = {
    "muldec-bulk-4096": {"shapes": [[64, 48]], "sets": 2},
    "muldec-bulk-ragged": {"shapes": [[37, 11], [5, 33], [3, 200]]},
    "aes128-fleet-256": {"shapes": [[6]], "sets": 2},
    "muldec-serve-open": {"pool_bytes": 1 << 20, "rate_per_s": 400},
}
# one group per flush, so that batches form (the half-batch fault needs two)
SERVE_BATCHED = {"pool_bytes": 1 << 20, "rate_per_s": 3000, "shapes": [[2, 3]]}
SEED = 2**33 + 17


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(cell, traffic=None, control=False, seconds=0.4, trace=False):
    out, lines = harness.run_cell(cell, SEED, seconds, trace, device="cpu",
                                  traffic=traffic or SMALL[cell], control=control)
    assert list(out)[-1] == "checks" and len(lines) == len(out["checks"])
    return out


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_program_is_correct(cell):
    out = _run(cell, trace=True)
    assert out["correct"], out
    assert out["attempted"] > 0 and out["failed"] == 0
    assert all(c["value"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct(cell):
    out = _run(cell, control=True)
    assert not out["correct"], out


def _flip_parity(mp, dispatch):
    orig = dispatch.mul_decrypt_auto

    def broken(a, b, mask):
        out, jm, za, zb, parity = orig(a, b, mask)
        return out, jm, za, zb, parity ^ 1
    mp.setattr(dispatch, "mul_decrypt_auto", broken)


def _half_product(mp, dispatch):
    orig = dispatch.mul_decrypt_auto

    def broken(a, b, mask):
        out, jm, za, zb, parity = orig(a, b, mask)
        out = out.clone()
        out[:, out.shape[1] // 2:] = 0
        return out, jm, za, zb, parity
    mp.setattr(dispatch, "mul_decrypt_auto", broken)


@pytest.mark.parametrize("cell", ["muldec-bulk-4096", "muldec-bulk-ragged"])
@pytest.mark.parametrize("fault", [_flip_parity, _half_product])
def test_bulk_faults_are_not_correct(monkeypatch, cell, fault):
    from csgn_tpu_torch.ops import dispatch

    fault(monkeypatch, dispatch)
    assert not _run(cell)["correct"]


def test_serve_altered_answer_is_not_correct(monkeypatch):
    from csgn_tpu_torch.ops import dispatch

    orig = dispatch.mul_decrypt_batched_auto

    def broken(a, b, mask):
        out, jm, za, zb, bits = orig(a, b, mask)
        out = out.clone()
        out[0, 0, 0] ^= 1 << 5
        return out, jm, za, zb, bits
    monkeypatch.setattr(dispatch, "mul_decrypt_batched_auto", broken)
    out = _run("muldec-serve-open", traffic=SERVE_BATCHED)
    assert not out["correct"]


def test_serve_half_batch_is_not_correct(monkeypatch):
    from csgn_tpu_torch.ops import dispatch

    orig = dispatch.mul_decrypt_batched_auto
    seen = []

    def broken(a, b, mask):
        n = a.shape[0]
        h = max(1, n // 2)
        out, jm, za, zb, bits = orig(a[:h], b[:h], mask)
        seen.append(n)
        reps = -(-n // h)
        return (out.repeat(reps, 1, 1)[:n].contiguous(), jm, za, zb, bits.repeat(reps)[:n])
    monkeypatch.setattr(dispatch, "mul_decrypt_batched_auto", broken)
    out = _run("muldec-serve-open", traffic=SERVE_BATCHED)
    assert max(seen) > 1
    assert not out["correct"]


def test_aes_altered_answer_is_not_correct(monkeypatch):
    from csgn_tpu_torch import serve

    orig = serve.eval_plain_packed

    def broken(netlist, inputs, b):
        outs = orig(netlist, inputs, b)
        outs[0][7] ^= 1  # one output bit of the fleet's first request
        return outs
    monkeypatch.setattr(serve, "eval_plain_packed", broken)
    assert not _run("aes128-fleet-256")["correct"]


def test_aes_half_fleet_is_not_correct(monkeypatch):
    from csgn_tpu_torch import serve

    orig = serve.BatchExecutor._run_netexpr

    def broken(self, payloads):
        h = max(1, len(payloads) // 2)
        done = orig(self, payloads[:h])
        return [done[i % h] for i in range(len(payloads))]
    monkeypatch.setattr(serve.BatchExecutor, "_run_netexpr", broken)
    assert not _run("aes128-fleet-256")["correct"]


def test_latency_counts_from_the_due_time():
    """A request due while an earlier one is flushed waits, and that wait
    counts in its latency."""
    import time

    from portbench import generator, tracing

    class SlowOp:
        def submit(self, shape, k):
            return k

        def flush(self):
            time.sleep(0.02)

        def result(self, handle):
            pass

    sched = generator.OpenSchedule(due=np.array([0.01, 0.011]), shape=np.array([0, 0]))
    res = harness.open_loop(SlowOp(), sched, tracing.Tracer(False, torch.device("cpu")))
    lat = res["latencies_s"]
    # the second waits for the first's flush (to 0.03), then its own (to 0.05)
    assert 0.02 <= lat[0] < 0.035 and lat[1] >= 0.035
    assert res["flush_sizes"].tolist() == [1, 1] and res["failed"] == 0


def test_batching_window_flushes_on_its_ticks():
    """With a batching window, requests wait for the next tick, and a flush
    that overruns the next tick is followed at once by one of every request
    due by then."""
    import time

    from portbench import generator, tracing

    flushes = []

    class Op:
        def submit(self, shape, k):
            return k

        def flush(self):
            flushes.append(time.perf_counter())
            if len(flushes) == 2:
                time.sleep(0.025)

        def result(self, handle):
            pass

    due = np.array([0.001, 0.004, 0.012, 0.021, 0.035, 0.06])
    sched = generator.OpenSchedule(due=due, shape=np.zeros(6, dtype=np.int64),
                                   flush_every_s=0.01)
    res = harness.open_loop(Op(), sched, tracing.Tracer(False, torch.device("cpu")))
    lat = res["latencies_s"]
    assert res["flush_sizes"].tolist() == [2, 1, 2, 1] and res["failed"] == 0
    assert res["overruns"] == 1
    assert 0.009 - 1e-4 <= lat[0] < 0.019 and 0.006 - 1e-4 <= lat[1] < 0.016
    # due at 0.021 and 0.035, during the flush that overruns to 0.045
    assert lat[3] >= 0.023 and lat[4] >= 0.009
    assert lat[5] < 0.015  # back to flushes a window apart after the catch-up
    assert res["flush_late_s"][0] < 0.009


def test_trace_reduction_attributes_idle_gaps():
    from portbench import tracing

    spans = [("serve.flush", 0.0, 0.4), ("serve.wait", 0.4, 1.0), ("inner", 0.1, 0.2)]
    segs = tracing._innermost(spans, 0.0, 1.2)
    assert segs == [(0.0, 0.1, "serve.flush"), (0.1, 0.2, "inner"), (0.2, 0.4, "serve.flush"),
                    (0.4, 1.0, "serve.wait"), (1.0, 1.2, tracing.NO_SPAN)]


def test_percentile_is_nearest_rank():
    v = np.arange(1, 101, dtype=float)
    assert harness.percentile(v, 95) == 95.0
    assert harness.percentile(np.array([1.0, np.inf]), 95) == np.inf
