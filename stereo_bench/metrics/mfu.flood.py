"""%: the FLOPs of the profiled ticks' frames over the profiled window's
seconds, both from ``torch.profiler``'s timeline, against the dense bf16
peak of an H100 SXM (989 TFLOP/s).  A frame's FLOPs are those of the
convolutions and matrix products of the benchmark's own reference forward
(``counts.frame_flops``, ``torch.utils.flop_counter`` on the meta device),
whatever implements them in the program.  The window holds the profiled
ticks' device work and the tail of the tick before them, so the share is
never counted high."""
from stereo_bench.counts import PEAK_BF16_FLOPS

UNIT = "%"


def read(run):
    trace = run.trace
    if (not run.flops_per_frame or trace is None or not trace.ops
            or trace.ticks <= 0 or trace.window_s <= 0):
        return None
    rate = run.flops_per_frame * run.batch * trace.ticks / trace.window_s
    return 100.0 * rate / PEAK_BF16_FLOPS
