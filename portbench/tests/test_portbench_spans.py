"""The program's own spans (`csgn_tpu_torch.utils.metrics`) beside the
harness's: an untraced run leaves the recorder off and empty; the idle-gap
attribution gives a gap to the innermost span, a program span nested under
a harness span of the same name included; and on the card, each fused
multiply+decrypt kernel starts inside its ``launch.mul_decrypt`` span, on
the host clock the trace's marker maps (to within the marker's own round
trip), and joining the program's spans to the harness's moves idle time
between names without changing its total.  The card's
test runs with ``python3 -m pytest -q portbench/tests/test_portbench_spans.py``."""

import pytest
import torch

from portbench import harness, tracing
from portbench.tests.test_portbench_ops import SEED, SMALL


@pytest.fixture
def recorder():
    from csgn_tpu_torch.utils.metrics import op_metrics

    rec = op_metrics()
    rec.disable()
    rec.reset()
    yield rec
    rec.disable()
    rec.reset()


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_untraced_run_records_no_program_span(recorder, cell):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out, _ = harness.run_cell(cell, SEED, 0.3, False, device="cpu", traffic=SMALL[cell])
    finally:
        torch.set_num_threads(threads)
    assert out["correct"]
    assert not recorder.enabled and recorder.spans() == []


def test_innermost_gives_a_gap_to_the_nested_program_span():
    spans = [("key.mul_and_decrypt", 0.0, 10.0),      # the harness's
             ("key.mul_and_decrypt", 1.0, 9.0),       # the program's, same name
             ("launch.mul_decrypt", 2.0, 3.0),
             ("key.readback", 7.0, 8.5)]
    segs = tracing._innermost(spans, 0.0, 12.0)
    assert segs == [(0.0, 1.0, "key.mul_and_decrypt"), (1.0, 2.0, "key.mul_and_decrypt"),
                    (2.0, 3.0, "launch.mul_decrypt"), (3.0, 7.0, "key.mul_and_decrypt"),
                    (7.0, 8.5, "key.readback"), (8.5, 9.0, "key.mul_and_decrypt"),
                    (9.0, 10.0, "key.mul_and_decrypt"), (10.0, 12.0, tracing.NO_SPAN)]
    # the program's flush under the harness's, each closing its own
    segs = tracing._innermost([("serve.flush", 0.0, 4.0), ("executor.flush", 1.0, 3.0),
                               ("executor.readback", 2.0, 2.5)], 0.0, 4.0)
    assert [s[2] for s in segs] == ["serve.flush", "executor.flush", "executor.readback",
                                    "executor.flush", "serve.flush"]


@pytest.mark.cuda
def test_kernels_start_inside_their_launch_spans(recorder):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from csgn_tpu_torch import Ciphertext, Context, SecretKey
    from csgn_tpu_torch.utils.metrics import clock
    from portbench.inputs import device_generator, fresh_chunks, key_positions

    dev = torch.device("cuda", 0)
    n, d, t, ops = 1247, 16, 2048, 20
    positions = key_positions(SEED, n, d)
    gen = device_generator(SEED, "operands", dev)
    ctx = Context(n, d)
    sk = SecretKey(ctx, positions, dev)
    a, b = (Ciphertext(fresh_chunks(torch.randint(0, 2, (t,), device=dev, generator=gen),
                                    positions, n, gen).T.contiguous(), ctx) for _ in range(2))
    sk.mul_and_decrypt(a, b)  # loads the kernel library
    tracer = tracing.Tracer(True, dev)
    tracer.start_profile()
    # The marker's host time is read before its launch, so the mapped device
    # times are early by its launch latency, less than its round trip.
    slack = clock() - tracer._marker_host
    recorder.enable()
    tracer.open_window()
    for _ in range(ops):
        with tracer.span("key.mul_and_decrypt", sync=True):
            sk.mul_and_decrypt(a, b)
    tracer.close_window()
    recorder.disable()
    launches = [s for s in recorder.spans() if s.name == "launch.mul_decrypt"]
    k2 = [e for e in tracing._device_events(tracer._prof) if "mul_kernel" in e[2]]
    assert len(launches) == len(k2) == ops
    offset = tracer.trace.clock_offset_s
    for span, (start, _, _) in zip(launches, k2):
        assert span.start - slack <= start - offset <= span.end + slack, (span, start - offset,
                                                                         slack)
    # Joined with the harness's spans, the program's spans take a share of
    # the same idle time: the attribution moves, the total does not.
    joined = tracer.spans + [(s.name, s.start, s.end) for s in recorder.spans()]
    trace = tracing._read(tracer._prof, tracer._marker_host, tracer._open, tracer._close,
                          joined)
    names = {name for name, _ in trace.idle_gaps}
    assert names <= {"key.mul_and_decrypt", "launch.mul_decrypt", "key.readback",
                     tracing.NO_SPAN}
    assert abs(sum(v for _, v in trace.idle_gaps)
               - sum(v for _, v in tracer.trace.idle_gaps)) < 1e-9
