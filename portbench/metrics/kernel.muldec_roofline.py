"""The fused multiply+decrypt's share of its memory roofline: the least time
the card could take for the window's ops (each operand read once and each
product written once, over the published HBM bandwidth) against the summed
duration of every device operation in the traced window.  So it counts the
same work whatever kernels do it."""

from portbench.peaks import HBM_BYTES_PER_S


def read(run):
    peak = HBM_BYTES_PER_S.get(run.device_kind)
    if run.trace is None or not run.bytes_needed or peak is None or run.trace.device_s <= 0:
        return None
    return 100.0 * (run.bytes_needed / peak) / run.trace.device_s
