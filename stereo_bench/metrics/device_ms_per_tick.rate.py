"""ms: the union of the device's operations (kernels and copies) in the
profiled ticks, over the ticks (``torch.profiler``)."""
UNIT = "ms"


def read(run):
    if run.trace is None or not run.trace.ops or run.trace.ticks <= 0:
        return None
    return 1e3 * run.trace.busy_s() / run.trace.ticks
