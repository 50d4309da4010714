"""Reduction of a ``torch.profiler`` session over a few dozen steady ticks:
the device's operations and the harness's own host spans (``bench.*``) in
the profiler's one timeline (microseconds)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

Interval = Tuple[float, float]


@dataclasses.dataclass
class Trace:
    ops: List[Tuple[str, float, float]]      # device operations
    spans: List[Tuple[str, float, float]]    # the harness's host spans
    start: float                             # the traced window
    end: float
    ticks: int                               # ticks profiled

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy(self) -> List[Interval]:
        """The union of device operations' intervals inside the window."""
        out: List[Interval] = []
        for _, s, e in sorted(self.ops, key=lambda op: op[1]):
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-6

    def gaps(self) -> List[Interval]:
        """The window's stretches with nothing running on the device."""
        out, t = [], self.start
        for s, e in self.busy():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.end > t:
            out.append((t, self.end))
        return out

    def op_seconds(self, names) -> float:
        """Summed device time of the operations whose name contains one of
        ``names``."""
        return sum(e - s for n, s, e in self.ops
                   if any(k in n for k in names)) * 1e-6

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps named by the harness span that covers each gap's middle."""
        by_name: Dict[str, float] = {}
        for n, s, e in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:160], v] for n, v in ops],
                "idle_gaps": [[self.host_at((s + e) / 2), (e - s) * 1e-6]
                              for s, e in gaps]}

    def host_at(self, t: float) -> str:
        """The innermost harness span running at time t."""
        best: Optional[Tuple[str, float, float]] = None
        for span in self.spans:
            if span[1] <= t <= span[2] and (
                    best is None or span[2] - span[1] < best[2] - best[1]):
                best = span
        return best[0] if best else "outside the harness's spans"


def from_profiler(prof, ticks: int) -> Trace:
    """Device operations (kernels, copies, sets) and ``bench.*`` spans of a
    finished profiler session; the window runs from the first span's start
    to the last span's end."""
    ops, spans = [], []
    for ev in prof.events():
        start, end = ev.time_range.start, ev.time_range.end
        if ev.name.startswith("bench."):
            # the profiler also draws a host span on the device's timeline
            if ev.device_type.name == "CPU":
                spans.append((ev.name, float(start), float(end)))
        elif ev.device_type.name == "CUDA":
            ops.append((ev.name, float(start), float(end)))
    if not spans:
        raise RuntimeError("the profile holds none of the harness's spans")
    return Trace(ops, spans, min(s for _, s, _ in spans),
                 max(e for _, _, e in spans), ticks)
