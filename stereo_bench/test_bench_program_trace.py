"""The readers of the program's own records (``program_trace.py`` and its
metrics) on a fabricated run: a profile whose timeline lies a known offset
from the host clock, the program's host spans and stage marks written into
its rings by hand, and a program without records."""
import types

import pytest
import torch

from stereo_bench import program_trace, spec
from stereo_bench.serve import Tick
from stereo_bench.trace import Trace

OFFSET_US = -123456.5          # the profiler's timeline less the host clock
TICK_US = 10_000.0
NEW = ["device_ms.temporal_update.flood", "device_ms.backbone.flood",
       "device_ms.coarse.flood", "device_ms.fine.flood",
       "device_ms.precise.flood", "device_ms.outputs.flood",
       "replay_host_ms_p99.flood", "idle_in_replay_ms.flood"]


def _records(stage, warp, ticks, older=2):
    """Program records of ``older`` + ``ticks`` replays of ``stage``: the
    older ones' segments 9 ms each, the window's 1..6 ms (tick i's
    backbone 2 + i ms); each step at 100 s + i * TICK_US on the host
    clock: step +5 us, replay +10..+400 us, step end +500 us."""
    from temporalstereo_tpu_torch import tracing

    rec = tracing.Records([(stage, warp)], torch.device("cpu"), slots=8)
    marks = rec.marks[stage]
    n = older + ticks
    for r in range(n):
        seg = [9.0] * len(marks.segments)
        if r >= older:
            seg = [float(k + 1) for k in range(len(marks.segments))]
            seg[marks.segments.index("backbone")] += r - older
        t = [r * 100_000_000]
        for ms in seg:
            t.append(t[-1] + int(ms * 1e6))
        marks.ring[r % 8] = torch.tensor(t)
        host = int(1e11 + (r - older) * TICK_US * 1e3)
        rec.stepped(stage, host + 5_000, host + 10_000, host + 400_000,
                    host + 500_000)
    marks.cursor[0] = n
    return rec


def _run(ticks=4, jitter=()):
    """Ticks at 100 s + i * TICK_US, all profiled; bench.submit spans from
    each stamp (plus ``jitter[i]`` us) on the profiler's timeline; device
    work per tick at +0..100, +300..420 and +460..2000 us, so the gaps'
    midpoints fall in the replay (200 us), in the step outside it (40 us)
    and in the harness (the rest)."""
    ts = [Tick(i, due=100.0 + i * TICK_US / 1e6, profiled=True)
          for i in range(ticks)]
    ops, spans = [], []
    for i, t in enumerate(ts):
        t.submit = t.due
        at = t.submit * 1e6 + OFFSET_US
        shift = jitter[i] if i < len(jitter) else 0.0
        spans += [("bench.submit", at + shift, at + 600),
                  ("bench.wait", at + 600, at + 2100)]
        ops += [("k", at, at + 100), ("k", at + 300, at + 420),
                ("k", at + 460, at + 2000)]
    trace = Trace(ops, spans, spans[0][1], spans[-1][2], ticks)
    return types.SimpleNamespace(ticks=ts, trace=trace)


@pytest.fixture
def program(monkeypatch):
    def use(rec):
        monkeypatch.setattr(program_trace, "records", lambda: rec)
    return use


def test_offset_and_its_spread():
    offset, spread = program_trace.clock_offset_us(_run())
    assert offset == pytest.approx(OFFSET_US, abs=1e-3)
    assert spread == pytest.approx(0.0, abs=1e-3)
    # one early span start (the session's first) moves neither
    offset, spread = program_trace.clock_offset_us(_run(9, jitter=(
        -900.0, 1.0, -1.0, 0.5, 0.0, 0.2, -0.3, 0.1, -0.1)))
    assert offset == pytest.approx(OFFSET_US, abs=1e-3)
    assert spread < 2.0


def test_idle_split_and_idle_in_replay(program):
    program(_records("steady", True, 4))
    run = _run()
    split = program_trace.idle_split_ms(run)
    assert split["replay"] == pytest.approx(0.2)
    assert split["step"] == pytest.approx(0.04)
    # three 8000 us gaps between ticks and the window's last 100 us
    assert split["harness"] == pytest.approx((3 * 8000 + 100) / 4 / 1e3)
    assert spec.reader("idle_in_replay_ms.flood").read(run) == \
        pytest.approx(0.2)


def test_segments_read_the_window_only(program):
    """The newest len(ticks) replays of the window's stage: the older ones
    are left out; tick i's backbone is 2 + i ms, median 3.5."""
    program(_records("steady", True, 4))
    run = _run()
    got = {m: spec.reader(m).read(run) for m in NEW[:6]}
    assert got == {"device_ms.temporal_update.flood": 1.0,
                   "device_ms.backbone.flood": 3.5,
                   "device_ms.coarse.flood": 3.0,
                   "device_ms.fine.flood": 4.0,
                   "device_ms.precise.flood": 5.0,
                   "device_ms.outputs.flood": 6.0}
    assert spec.reader("replay_host_ms_p99.flood").read(run) == \
        pytest.approx(0.39)


def test_single_frame_model_has_no_temporal_update(program):
    program(_records("single", False, 4))
    run = _run()
    assert spec.reader(NEW[0]).read(run) is None
    assert spec.reader("device_ms.backbone.flood").read(run) == 2.5


def test_without_program_records_nothing_is_read(program):
    program(None)
    run = _run()
    assert all(spec.reader(m).read(run) is None for m in NEW)
    assert program_trace.clock_offset_us(run)[0] == \
        pytest.approx(OFFSET_US)
