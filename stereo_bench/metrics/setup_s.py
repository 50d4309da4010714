"""s: process start to the first timed tick (host clock): imports, the
weights and frames, the model, the bundle's captures (the kernels' build
in a checkout's first run), the growth stages and the warm ticks."""
UNIT = "s"


def read(run):
    return run.setup_s
