"""%: the share of the profiled window with nothing running on the device
(``torch.profiler``; the window runs from the first profiled tick's submit
to the last one's completion)."""
UNIT = "%"


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
