"""The port's one recorder (`csgn_tpu_torch.utils.metrics`): counts always,
spans only while recording, with parent links, ids and self times, at the
serving, API and kernel boundaries; the CLI's table on recorded spans."""

import math

import pytest
import torch

import csgn_tpu_torch as T
import csgn_tpu_torch.utils as tutils
from csgn_tpu_torch import cli
from csgn_tpu_torch.utils import metrics as M


@pytest.fixture
def rec():
    """The global recorder, cleared and off before and after the test."""
    r = M.op_metrics()
    r.disable()
    r.reset()
    yield r
    r.disable()
    r.reset()


@pytest.fixture(scope="module")
def key():
    ctx = T.Context(95, 4)
    return T.SecretKey.generate(ctx, T.rng.key(3), device="cpu")


def _ct(sk, chunks, seed):
    bits = torch.arange(chunks, dtype=torch.int32) % 2
    return T.Ciphertext(sk.encrypt_batch(bits, seed), sk.ctx)


def _children(spans, i):
    return [j for j, s in enumerate(spans) if s.parent == i]


def test_off_records_no_span_and_reads_no_clock(rec, key, monkeypatch):
    def no_clock():
        raise AssertionError("a clock was read with recording off")

    monkeypatch.setattr(M, "clock", no_clock)
    a, b = _ct(key, 3, 1), _ct(key, 2, 2)
    prod, bit = key.mul_and_decrypt(a, b)
    ex = T.BatchExecutor(key)
    futs = [ex.submit_mul_decrypt(a, b), ex.submit_mul_decrypt(b, a)]
    ex.flush()
    assert [f.result()[1] for f in futs] == [int(bit)] * 2
    assert not rec.enabled and rec.spans() == []
    snap = rec.snapshot()
    assert snap["key.mul_and_decrypt"] == {"calls": 1, "chunks_in": 5, "chunks_out": 6,
                                           "bytes_moved": key.ctx.chunk_count_bytes(11),
                                           "seconds": 0.0}
    assert snap["serve.muldec"]["calls"] == 2 and snap["dispatch.mul_dec.plain"]["calls"] == 1
    assert rec.span("x") is rec.span("y", 7) is M._NO_SPAN
    assert rec.record("z") is M._NO_SPAN and rec.snapshot()["z"]["calls"] == 1


def test_mul_and_decrypt_spans(rec, key):
    a, b = _ct(key, 3, 1), _ct(key, 4, 2)
    with rec.recording():
        key.mul_and_decrypt(a, b)
    assert not rec.enabled
    spans = rec.spans()
    assert [(s.name, s.parent) for s in spans] == [("key.mul_and_decrypt", -1),
                                                   ("key.readback", 0)]
    op, rb = spans
    assert op.start <= rb.start <= rb.end <= op.end and op.attrs["chunks_out"] == 12
    own = M.self_times(spans)
    assert math.isclose(own[0], op.seconds - rb.seconds) and own[1] == rb.seconds
    assert rec.snapshot()["key.mul_and_decrypt"]["seconds"] == op.seconds
    # decrypt reads its parity back under the same child name
    rec.reset()
    with rec.recording():
        key.decrypt(a)
    assert [(s.name, s.parent) for s in rec.spans()] == [("key.decrypt", -1),
                                                         ("key.readback", 0)]


def test_flush_spans(rec, key):
    ex = T.BatchExecutor(key)
    ex.submit_mul_decrypt(_ct(key, 2, 9), _ct(key, 3, 10))  # before recording: no span
    pairs = [(_ct(key, 2, 11), _ct(key, 3, 12))]
    pairs += [(_ct(key, 1, s), _ct(key, 4, s + 1)) for s in (15, 17, 19)]
    with rec.recording():
        futs = [ex.submit_mul_decrypt(a, b) for a, b in pairs]
        ex.flush()
    spans = rec.spans()
    submits = [s for s in spans if s.name == "executor.submit"]
    assert [s.id for s in submits] == [1, 2, 3, 4]
    assert all(s.parent == -1 for s in submits)
    (flush,) = [i for i, s in enumerate(spans) if s.name == "executor.flush"]
    assert spans[flush].id == 0 and spans[flush].parent == -1
    groups = _children(spans, flush)
    assert [spans[g].name for g in groups] == ["serve.muldec"] * 2
    assert [spans[g].attrs["chunks_in"] for g in groups] == [2, 3]  # requests per group
    under = [i for i, s in enumerate(spans) if i > flush]
    assert all(spans[i].id == 0 for i in under)
    for g in groups:
        names = [spans[j].name for j in _children(spans, g)]
        assert names == ["executor.stack", "key.mul_and_decrypt_batch", "executor.readback",
                         "executor.unpack"]
    assert all(f.done for f in futs)
    own = M.self_times(spans)
    assert all(t >= -1e-9 for t in own)
    assert math.isclose(sum(own[i] for i in [flush, *under]), spans[flush].seconds,
                        rel_tol=1e-9, abs_tol=1e-12)


def test_failed_group_delivers_through_futures(rec, key, monkeypatch):
    """A runner that raises fails its group's futures, spans closed."""
    ex = T.BatchExecutor(key)
    futs = [ex.submit_mul_decrypt(_ct(key, 1, 3), _ct(key, 1, 4)) for _ in range(2)]

    def broken(payloads):
        raise RuntimeError("device lost")

    monkeypatch.setattr(ex, "_run_muldec", broken)
    with rec.recording():
        ex.flush()
    for f in futs:
        with pytest.raises(RuntimeError, match="device lost"):
            f.result()
    assert [s.name for s in rec.spans()] == ["executor.flush", "serve.muldec"]
    assert all(not math.isnan(s.end) for s in rec.spans())


def test_reset_clears_spans_and_counts(rec, key):
    ct = _ct(key, 2, 8)
    with rec.recording():
        with rec.span("outer", 5, {"k": 1}):
            with rec.span("inner"):
                pass
        assert [(s.name, s.parent, s.id, s.attrs) for s in rec.spans()] == [
            ("outer", -1, 5, {"k": 1}), ("inner", 0, 5, None)]
        with rec.span("open"):
            rec.reset()
            with rec.span("after"):
                pass
        key.decrypt(ct)
    assert [(s.name, s.parent) for s in rec.spans()] == [
        ("after", -1), ("key.decrypt", -1), ("key.readback", 1)]
    rec.reset()
    assert rec.spans() == [] and rec.snapshot() == {}


def test_cli_metrics_table_has_ms(rec, capsys):
    assert cli.main(["selftest", "--n", "95", "--d", "4", "--device", "cpu", "--metrics"]) == 0
    out = capsys.readouterr().out
    assert "per-op metrics (host time per op):" in out
    row = next(line for line in out.splitlines() if line.startswith("key.encrypt "))
    assert float(row.split()[-1]) > 0
    assert not rec.enabled


def test_trace_and_gbps_are_gone(rec, key):
    assert not hasattr(tutils, "trace") and "trace" not in tutils.__all__
    assert not hasattr(M, "trace")
    key.decrypt(_ct(key, 1, 2))
    assert set(rec.snapshot()["key.decrypt"]) == {"calls", "chunks_in", "chunks_out",
                                                  "bytes_moved", "seconds"}
