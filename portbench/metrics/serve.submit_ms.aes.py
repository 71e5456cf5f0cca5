"""Mean host time of the harness's span around one fleet's submissions: the
client's `Ciphertext` wrappers and every ``submit_netlist_expr`` call."""

from portbench.tracing import mean_ms


def read(run):
    return mean_ms(run.tracer, "serve.submit")
