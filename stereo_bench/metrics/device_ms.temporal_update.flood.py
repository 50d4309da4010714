"""ms: the median over the window's replays of the device time between the
program's marks at the captured stage function's entry and the model's
entry: the pose warp and the softsplat of the carried state (the device's
own clock, ``program_trace.segment_ms``)."""
from stereo_bench.program_trace import segment_ms

UNIT = "ms"


def read(run):
    return segment_ms(run, "temporal_update")
