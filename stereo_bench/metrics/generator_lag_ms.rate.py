"""ms: how late the open loop submitted, the 95th percentile (nearest rank)
over the window's ticks of submit time less due time (host clock)."""
import math

UNIT = "ms"


def read(run):
    lag = sorted(1e3 * (t.submit - t.due) for t in run.ticks
                 if not t.profiled)
    return lag[math.ceil(0.95 * len(lag)) - 1] if lag else None
