"""ms: the 99th percentile (nearest rank) over the window's ticks of the
program's ``replay`` span inside ``StreamingBundle.step``
(``CUDAGraph.replay``, host clock; ``program_trace.replay_ms``)."""
import math

from stereo_bench.program_trace import replay_ms

UNIT = "ms"


def read(run):
    ms = sorted(replay_ms(run) or [])
    return ms[math.ceil(0.99 * len(ms)) - 1] if ms else None
