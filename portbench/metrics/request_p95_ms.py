"""The 95th percentile (nearest rank) of the latency of every request due in
the window, each timed from its due time until its result is in the
client's hands; a request that failed counts as missing (infinite)."""

from portbench.harness import percentile


def read(run):
    return None if run.latencies_s is None else percentile(run.latencies_s, 95) * 1e3
