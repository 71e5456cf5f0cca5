"""The device's idle share of the traced window: one less the union of the
intervals in which any device operation ran, over the window's host wall."""

from portbench.tracing import idle_pct


def read(run):
    return idle_pct(run.trace)
