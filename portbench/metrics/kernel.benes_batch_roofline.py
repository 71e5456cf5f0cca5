"""K9's share of its roofline: the least time the card could take for the
window's Beneš networks, their operations (counted by
`portbench.rekey_work`, the same count `kernel.rekey_roofline` takes) over
the card's int32 rate, against the summed device time of the trace's
``benes_register_kernel`` entries alone.  In ``rotate-fleet`` only K9
(`apply_benes_batch`: plan i on element i) launches that kernel.  None where
no such kernel ran in the window or where the op counted no operations."""

from portbench.rekey_work import INT32_OPS_PER_S, window_ops

KERNEL = "benes_register_kernel"


def read(run):
    rate = INT32_OPS_PER_S.get(run.device_kind)
    ops = window_ops(run.tracer)
    if run.trace is None or rate is None or not ops:
        return None
    kernel_s = sum(s for name, s in run.trace.device_ops if KERNEL in name)
    if kernel_s <= 0:
        return None
    return 100.0 * (ops / rate) / kernel_s
