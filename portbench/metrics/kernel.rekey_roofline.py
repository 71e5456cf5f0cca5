"""The re-key's share of its roofline: the least time the card could take
for the window's ops, the larger of their bytes over the published HBM
bandwidth and their Beneš operations over the card's int32 rate (both
counted by `portbench.rekey_work`), against the summed duration of every
device operation in the traced window.  So it counts the same work whatever
kernels do it.  Where the op counted no operations the bound is the bytes'
alone, a lower bound, so the share never reads above the work's."""

from portbench.peaks import HBM_BYTES_PER_S
from portbench.rekey_work import INT32_OPS_PER_S, window_ops


def read(run):
    bw, rate = HBM_BYTES_PER_S.get(run.device_kind), INT32_OPS_PER_S.get(run.device_kind)
    if run.trace is None or not run.bytes_needed or bw is None or rate is None \
            or run.trace.device_s <= 0:
        return None
    bound = max(run.bytes_needed / bw, (window_ops(run.tracer) or 0.0) / rate)
    return 100.0 * bound / run.trace.device_s
