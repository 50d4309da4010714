"""%: the temporal update's softmax splat's share of its bound: the bytes
of a tick's splat (``counts.softsplat_bytes``) over 3.35 TB/s, against the
summed device time of the kernels named below in the profiled ticks."""
from stereo_bench.counts import HBM_BYTES_PER_S

UNIT = "%"
KERNELS = ("softsplat_kernel",)


def read(run):
    if run.trace is None or run.trace.ticks <= 0:
        return None
    seconds = run.trace.op_seconds(KERNELS) / run.trace.ticks
    nbytes = run.bytes_per_tick["softsplat"]
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
