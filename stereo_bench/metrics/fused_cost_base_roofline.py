"""%: the fused cost base's share of its bound: the bytes the fine and
precise cost bases of a tick must move (``counts.cost_base_bytes``: each
input read once, the volume written once) over 3.35 TB/s, against the
summed device time of the kernels named below in the profiled ticks.  The
kernel is bound by bytes (its FLOPs take under 1% of the time at peak)."""
from stereo_bench.counts import HBM_BYTES_PER_S

UNIT = "%"
KERNELS = ("fused_cost_base_kernel",)


def read(run):
    if run.trace is None or run.trace.ticks <= 0:
        return None
    seconds = run.trace.op_seconds(KERNELS) / run.trace.ticks
    nbytes = run.bytes_per_tick["cost_base"]
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
