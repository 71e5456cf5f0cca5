"""Product chunks multiplied and decrypted (fused) per second over the whole
window; a closed loop's window ends when the op in flight at its close
completes."""


def read(run):
    return run.units / run.window_s if run.unit == "chunks" else None
