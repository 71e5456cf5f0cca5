"""Share of the window's perm groups whose requests K9 read where they are
stored, in %: the program's counter ``executor.perm.inplace`` over it and
``executor.perm.stacked`` (`BatchExecutor._run_perm`: one count a group, by
its route).  The `rotate_fleet` op resets the program's counts as the window
opens.  None where the program has neither counter or the window no group."""


def read(run):
    from csgn_tpu_torch.utils.metrics import op_metrics

    snap = op_metrics().snapshot()
    inplace, stacked = (snap.get(f"executor.perm.{route}", {}).get("calls", 0)
                        for route in ("inplace", "stacked"))
    if not inplace + stacked:
        return None
    return 100.0 * inplace / (inplace + stacked)
