"""ms: the device's idle time per profiled tick in the gaps whose midpoint
falls inside a program ``replay`` span (``CUDAGraph.replay`` on the host),
the spans placed on the profiler's timeline through the ticks' submit
stamps (``program_trace.idle_split_ms``)."""
from stereo_bench.program_trace import idle_split_ms

UNIT = "ms"


def read(run):
    split = idle_split_ms(run)
    return None if split is None else split["replay"]
