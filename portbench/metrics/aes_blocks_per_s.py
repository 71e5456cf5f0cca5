"""AES-128 blocks evaluated under encryption and read out per second over the
whole window; the window ends when the fleet in flight at its close
completes."""


def read(run):
    return run.units / run.window_s if run.unit == "blocks" else None
