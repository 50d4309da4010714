"""ms: the median over the window's replays of the device time between the
program's marks at the coarse and the fine stage's exits (the device's own
clock, ``program_trace.segment_ms``)."""
from stereo_bench.program_trace import segment_ms

UNIT = "ms"


def read(run):
    return segment_ms(run, "fine")
