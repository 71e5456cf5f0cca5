"""Mean host time of the harness's span around the executor's ``flush()`` and
the reads of the flushed requests' results."""

from portbench.tracing import mean_ms


def read(run):
    return mean_ms(run.tracer, "serve.flush")
