"""Records of the served stream, kept by ``serving.StreamingBundle`` without
a profiler: where a replay's device time goes by model stage, where a
step's host time goes, and what the replays ran.

Device marks.  Each stage graph holds a mark (``kernels/mark.py``, a
one-thread kernel that writes the device's clock) at these points, in
stream order:

  entry     the captured stage function's entry (warping stages only)
  model     ``TemporalStereoNet``'s entry (a forward pre-hook)
  backbone  the exit of ``model.backbone`` (forward hooks from here on)
  coarse    the exit of ``model.aggregation.coarse``
  fine      the exit of ``model.aggregation.fine``
  precise   the exit of ``model.aggregation.precise``
  end       the stage function's end, after the steady stage's copy of its
            new state into its inputs; it advances the ring's cursor

so a replay splits into the segments ``temporal_update`` (the pose warp and
the softsplat; not in g0 or single), ``backbone``, ``coarse``, ``fine``,
``precise`` and ``outputs`` (the full-resolution resizes, the state's
casts, the steady copy).  Each stage has its own ring [SLOTS, marks] of
int64 ns and a cursor on the model's device, read back only on request.
The hooks exist only while the bundle captures a stage (on a card) or runs
one eagerly (on the CPU, where the marks read the host's clock): calling
the model anywhere else records nothing.

Host spans.  ``step`` (the whole ``StreamingBundle.step``) and ``replay``
(``CUDAGraph.replay``, or the eager stage call on the CPU), on
``time.perf_counter_ns()``, in a ring of the newest SLOTS steps.

Counters.  Replays by stage; the hand-written launches captured into each
stage's graph, which every replay adds to ``kernels.LAUNCHES``.

``newest()`` returns the records of the newest bundle, which outlive it.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .kernels import LAUNCHES, trace_mark

POINTS = ("entry", "model", "backbone", "coarse", "fine", "precise", "end")
SEGMENTS = ("temporal_update", "backbone", "coarse", "fine", "precise",
            "outputs")
HOST_SPANS = ("step", "replay")
SLOTS = 4096            # replays a stage's ring holds, steps the host's

_NEWEST: Optional["Records"] = None


def _nearest_rank(values: Iterable[float], q: float) -> float:
    """The q-quantile of ``values`` by nearest rank (nan for none)."""
    v = np.sort(np.asarray(list(values), dtype=np.float64))
    return float(v[max(math.ceil(q * len(v)), 1) - 1]) if len(v) else math.nan


def _summary(ms: np.ndarray) -> Dict[str, float]:
    return {"p50": _nearest_rank(ms, 0.5), "p99": _nearest_rank(ms, 0.99)}


class StageMarks:
    """The device marks of one stage graph and their ring."""

    def __init__(self, warp: bool, device: torch.device, slots: int = SLOTS):
        self.points = POINTS if warp else POINTS[1:]
        self.segments = SEGMENTS if warp else SEGMENTS[1:]
        self.ring = torch.zeros((slots, len(self.points)), dtype=torch.int64,
                                device=device)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=device)

    def mark(self, point: str) -> None:
        trace_mark(self.ring, self.cursor, self.points.index(point),
                   advance=point == "end")

    @contextlib.contextmanager
    def around(self, model: torch.nn.Module):
        """Marks the block: its entry (warping stages), the model's entry
        and its stages' exits while the block runs, and its end when it
        returns without raising."""
        if self.points[0] == "entry":
            self.mark("entry")
        handles = [model.register_forward_pre_hook(
            lambda module, args: self.mark("model"))]
        for point, module in (("backbone", model.backbone),
                              ("coarse", model.aggregation.coarse),
                              ("fine", model.aggregation.fine),
                              ("precise", model.aggregation.precise)):
            handles.append(module.register_forward_hook(
                lambda module, args, out, point=point: self.mark(point)))
        try:
            yield
        finally:
            for handle in handles:
                handle.remove()
        self.mark("end")

    def newest(self, n: Optional[int] = None) -> np.ndarray:
        """[k, marks] ns of the newest k = min(n, replays, slots) replays,
        oldest first (a synchronisation on a card)."""
        count = int(self.cursor[0])
        ring = self.ring.cpu().numpy()
        k = min(count, len(ring)) if n is None else min(n, count, len(ring))
        return ring[(count - k + np.arange(k)) % len(ring)]

    def segment_ms(self, n: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Each segment's ms in the newest n replays, oldest first."""
        ms = np.diff(self.newest(n), axis=1) / 1e6
        return {s: ms[:, i] for i, s in enumerate(self.segments)}


class Records:
    """The marks, host spans and counters of one bundle's stages."""

    def __init__(self, stages: List[Tuple[str, bool]], device: torch.device,
                 slots: int = SLOTS):
        self.names = [name for name, _ in stages]
        self.marks = {name: StageMarks(warp, device, slots)
                      for name, warp in stages}
        self.replays = {name: 0 for name in self.names}
        # per stage, the hand-written launches one replay runs
        self.launches: Dict[str, Dict[str, int]] = {n: {} for n in self.names}
        self._index = {name: i for i, name in enumerate(self.names)}
        # per step: stage, step start, replay start, replay end, step end
        self._host = np.zeros((slots, 5), dtype=np.int64)
        self._steps = 0

    def captured(self, stage: str, before: Dict[str, int]) -> None:
        """Keep the launches captured into ``stage``'s graph since
        ``before`` (a copy of LAUNCHES) and take them back: a capture runs
        nothing."""
        self.launches[stage] = {k: LAUNCHES[k] - v for k, v in before.items()
                                if LAUNCHES[k] != v}
        LAUNCHES.update(before)

    def stepped(self, stage: str, step: int, replay: int, replayed: int,
                end: int) -> None:
        """One step of ``stage``, its four host clock readings in ns."""
        self.replays[stage] += 1
        for k, v in self.launches[stage].items():
            LAUNCHES[k] += v
        self._host[self._steps % len(self._host)] = (
            self._index[stage], step, replay, replayed, end)
        self._steps += 1

    def host_spans(self, stage: Optional[str] = None,
                   n: Optional[int] = None) -> np.ndarray:
        """[k, 4] ns (step start, replay start, replay end, step end) of
        the newest n steps (of ``stage``) the ring holds, oldest first."""
        k = min(self._steps, len(self._host))
        rows = self._host[(self._steps - k + np.arange(k)) % len(self._host)]
        if stage is not None:
            rows = rows[rows[:, 0] == self._index[stage]]
        if n is not None:
            rows = rows[len(rows) - min(n, len(rows)):]
        return rows[:, 1:]

    def host_ms(self, span: str, stage: Optional[str] = None,
                n: Optional[int] = None) -> np.ndarray:
        """The ``step`` or ``replay`` span's ms of the newest n steps."""
        t = self.host_spans(stage, n)
        lo, hi = {"step": (0, 3), "replay": (1, 2)}[span]
        return (t[:, hi] - t[:, lo]) / 1e6

    def stats(self, n: Optional[int] = None) -> Dict[str, object]:
        """For an operator, without a profiler: replays by stage; per
        stage and segment the p50 / p99 device ms over the newest n
        replays (all the ring holds by default); the p50 / p99 host ms of
        ``step`` and ``replay`` over the newest n steps; LAUNCHES."""
        device = {}
        for name in self.names:
            if self.replays[name]:
                device[name] = {s: _summary(ms) for s, ms in
                                self.marks[name].segment_ms(n).items()}
        return {"replays": dict(self.replays), "device_ms": device,
                "host_ms": {span: _summary(self.host_ms(span, n=n))
                            for span in HOST_SPANS},
                "launches": dict(LAUNCHES)}


def keep(records: Records) -> None:
    """Make ``records`` the newest bundle's."""
    global _NEWEST
    _NEWEST = records


def newest() -> Optional[Records]:
    """The newest bundle's records (None before any bundle)."""
    return _NEWEST
