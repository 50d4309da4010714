"""ms: the 95th percentile (nearest rank) over every tick due in the window
of the time its disparities were in host memory less its due time (host
clock).  A tick never done reads as infinitely late."""
import math

UNIT = "ms"


def read(run):
    lat = sorted(1e3 * (t.done - t.due) if not math.isnan(t.done)
                 else math.inf for t in run.ticks)
    return lat[math.ceil(0.95 * len(lat)) - 1] if lat else None
