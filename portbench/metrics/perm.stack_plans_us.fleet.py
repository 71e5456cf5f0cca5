"""Host time of a fleet's plan stack, in µs: the program's
``perm.stack_plans`` spans (`CiphertextBatch.apply_permutations`: the
stack of the fleet's Beneš plans and the stacked masks' copy to the device,
which waits for the stream), summed over the window and divided by its
fleets (the harness's ``rotate.fleet`` spans).  The program's recorder is
on in a traced run of the `rotate_fleet` op.  None where the program has no
``perm.stack_plans`` span or the window no fleet."""


def read(run):
    from csgn_tpu_torch.utils.metrics import op_metrics

    fleets = len(run.tracer.durations("rotate.fleet")) if run.tracer is not None else 0
    spans = [s.seconds for s in op_metrics().spans() if s.name == "perm.stack_plans"]
    if not fleets or not spans:
        return None
    return 1e6 * sum(spans) / fleets
