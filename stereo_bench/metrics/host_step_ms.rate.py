"""ms: the median over the window's ticks of the harness's span around the
serving entry (frames copied in, ``StreamingBundle.step``: the input
copies, the replay's enqueue, the clone; the disparities' copy out
enqueued), host clock."""
import statistics

UNIT = "ms"


def read(run):
    spans = [1e3 * (t.stepped - t.submit) for t in run.ticks
             if not t.profiled]
    return statistics.median(spans) if spans else None
