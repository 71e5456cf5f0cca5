"""Set-up: process start to the window's open (loading, inputs, warm-up and,
in a run that compiles, compilation), on the host's clock."""


def read(run):
    return run.setup_s
