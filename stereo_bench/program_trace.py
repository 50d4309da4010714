"""The program's own records of a run (``temporalstereo_tpu_torch.tracing``,
the newest bundle's): its stage marks on the device's clock, and its host
spans inside ``StreamingBundle.step`` placed on the profiler's timeline.

The window's records are the newest ``len(run.ticks)`` replays of the
window's stage (``steady``, or ``single`` for a model without temporal
state), as many as the program's rings hold.  A program that keeps no such
records gives None everywhere, and the metrics that read them are left out
of the result line.
"""
from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional, Tuple

WINDOW_STAGES = ("steady", "single")


def records():
    """The program's records of its newest bundle, or None."""
    try:
        from temporalstereo_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.newest()


def _window(run):
    """(records, the window's stage) or None."""
    rec = records()
    if rec is None or not run.ticks:
        return None
    stage = next((s for s in WINDOW_STAGES if s in rec.names), None)
    return None if stage is None else (rec, stage)


def segment_ms(run, segment: str) -> Optional[float]:
    """The median over the window's replays of the device ms between the
    two marks around ``segment``; None where the stage has no such
    segment."""
    found = _window(run)
    if found is None:
        return None
    rec, stage = found
    marks = rec.marks[stage]
    if segment not in marks.segments:
        return None
    ms = marks.segment_ms(len(run.ticks))[segment]
    return float(statistics.median(ms)) if len(ms) else None


def replay_ms(run) -> Optional[List[float]]:
    """The host ms of the program's ``replay`` span over the window's
    ticks."""
    found = _window(run)
    if found is None:
        return None
    rec, stage = found
    ms = rec.host_ms("replay", stage, len(run.ticks))
    return [float(x) for x in ms] if len(ms) else None


def clock_offset_us(run) -> Optional[Tuple[float, float]]:
    """(offset, spread) in us taking the host clock (``perf_counter``) to
    the profiler's timeline.  The harness stamps ``tick.submit`` right after
    it enters the tick's ``bench.submit`` span, so the two are one instant
    on the two clocks: the offset is the median over the profiled ticks of
    their difference, the spread the distance between its quartiles."""
    trace = run.trace
    if trace is None:
        return None
    starts = sorted(s for name, s, _ in trace.spans if name == "bench.submit")
    stamps = [t.submit for t in run.ticks if t.profiled]
    if not stamps or len(starts) != len(stamps):
        return None
    offsets = [s - 1e6 * t for s, t in zip(starts, stamps)]
    if len(offsets) < 2:
        return offsets[0], 0.0
    q = statistics.quantiles(offsets, n=4)
    return statistics.median(offsets), q[2] - q[0]


def profiled_spans_us(run) -> Optional[List[Tuple[float, float, float,
                                                  float]]]:
    """The profiled ticks' program spans (step start, replay start, replay
    end, step end) on the profiler's timeline, in us."""
    found, trace = _window(run), run.trace
    aligned = clock_offset_us(run)
    if found is None or aligned is None or trace.ticks <= 0:
        return None
    rec, stage = found
    spans = rec.host_spans(stage, trace.ticks)
    if len(spans) != trace.ticks:
        return None
    offset = aligned[0]
    return [tuple(float(t) / 1e3 + offset for t in row) for row in spans]


def idle_split_ms(run) -> Optional[Dict[str, float]]:
    """The profiled window's idle ms per profiled tick, by where the host
    was at each idle gap's midpoint: inside the program's ``replay`` span,
    inside its ``step`` span outside the replay, or elsewhere (the
    harness)."""
    spans = profiled_spans_us(run)
    if spans is None:
        return None
    starts = [s[0] for s in spans]
    split = {"replay": 0.0, "step": 0.0, "harness": 0.0}
    for lo, hi in run.trace.gaps():
        mid = (lo + hi) / 2
        i = bisect.bisect_right(starts, mid) - 1
        where = "harness"
        if i >= 0 and mid <= spans[i][3]:
            where = "replay" if spans[i][1] <= mid <= spans[i][2] else "step"
        split[where] += hi - lo
    return {k: 1e-3 * v / run.trace.ticks for k, v in split.items()}
