"""Beneš plan bytes copied to a device a fleet, in KB (1,000 bytes): the
program's counter ``perm.plan_upload_bytes`` (its bytes, one count a cache
miss of `permute_benes.device_operands`: a plan's or a stack of plans'
masks and stage schedule), over the window, divided by its fleets (the
harness's ``rotate.fleet`` spans).  The `rotate_fleet` op resets the
program's counts as the window opens.  None where the program has no such
counter or the window no fleet."""


def read(run):
    from csgn_tpu_torch.utils.metrics import op_metrics

    fleets = len(run.tracer.durations("rotate.fleet")) if run.tracer is not None else 0
    uploads = op_metrics().snapshot().get("perm.plan_upload_bytes")
    if not fleets or uploads is None:
        return None
    return uploads["bytes_moved"] / 1e3 / fleets
