"""The served stream's records (temporalstereo_tpu_torch/tracing.py) on the
CPU, tiny model at 96x128: the stage marks' placement (read on the host's
clock where a card reads the device's), the host spans, the replay counts,
the rings' wrap-around, and the launches a replay adds to LAUNCHES."""
import time

import numpy as np
import pytest
import torch

from temporalstereo_tpu_torch import tracing
from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.kernels import LAUNCHES
from temporalstereo_tpu_torch.models import build_model, streaming_step
from temporalstereo_tpu_torch.serving import (StreamingBundle, bundle_meta,
                                              initial_prev)

H, W = 96, 128
TINY = ["MODEL.BACKBONE.VARIANT", "tiny", "MODEL.AGGREGATION.COARSE.C", "8",
        "MODEL.AGGREGATION.FINE.C", "8", "MODEL.AGGREGATION.PRECISE.C", "8",
        "TRAINER.PRECISION", "f32"]
TEMPORAL = ["MODEL.WITH_PREVIOUS", "True", "MODEL.USE_PAST_COST", "True",
            "MODEL.LOCAL_MAP_SIZE", "3", "MODEL.BACKBONE.MEMORY_PERCENT",
            "0.5"]
SCHEDULE = ["g0", "g1", "g2", "g3", "steady", "steady"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(n, seed=5):
    g = torch.Generator().manual_seed(seed)
    frames = [(torch.rand((1, H, W, 3), generator=g),
               torch.rand((1, H, W, 3), generator=g)) for _ in range(n)]
    K = torch.tensor([[[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]]])
    T = torch.eye(4)[None].clone()
    T[0, 2, 3] = -0.5
    return frames, K, torch.full((1,), 0.5), T


@pytest.fixture(scope="module")
def served(one_thread):
    """The temporal bundle run over the schedule twice (a reset between),
    its disparities, and the records as they stood after it."""
    model = build_model(get_cfg(opts=TINY + TEMPORAL), device="cpu", seed=3)
    bundle = StreamingBundle(bundle_meta(model, 1, H, W), model,
                             progress=lambda msg: None)
    frames, K, bl, T = _inputs(len(SCHEDULE))
    stages, disps, replays = [], [], []
    for _ in range(2):
        bundle.reset()
        for left, right in frames:
            stages.append(bundle.stage_name())
            disps.append(bundle.step(left, right, K, bl, T))
        replays.append(dict(bundle.records.replays))
    return {"model": model, "bundle": bundle, "stages": stages,
            "disps": disps, "replays": replays,
            "inputs": (frames, K, bl, T)}


@pytest.fixture(scope="module")
def single(one_thread):
    model = build_model(get_cfg(opts=TINY), device="cpu", seed=4)
    bundle = StreamingBundle(bundle_meta(model, 1, H, W), model,
                             progress=lambda msg: None)
    frames, K, bl, T = _inputs(2, seed=6)
    for left, right in frames:
        bundle.step(left, right, K, bl, T)
    return bundle


def test_segments_by_stage(served, single):
    """The warping stages split into all six segments; g0 and the
    single-frame model have no temporal update."""
    marks = served["bundle"].records.marks
    assert marks["g0"].segments == tracing.SEGMENTS[1:]
    for name in ("g1", "g2", "g3", "steady"):
        assert marks[name].segments == tracing.SEGMENTS
        assert marks[name].points == tracing.POINTS
    assert single.records.marks["single"].segments == tracing.SEGMENTS[1:]
    assert set(single.stats()["device_ms"]["single"]) == set(
        tracing.SEGMENTS[1:])


def test_segments_cover_each_replay(served, single):
    """Every replay's segments are non-negative and sum to its end mark
    less its first."""
    for records in (served["bundle"].records, single.records):
        for name, marks in records.marks.items():
            t = marks.newest()
            assert len(t) == records.replays[name] > 0
            ms = marks.segment_ms()
            total = sum(ms[s] for s in marks.segments)
            assert all((ms[s] >= 0).all() for s in marks.segments)
            np.testing.assert_allclose(total, (t[:, -1] - t[:, 0]) / 1e6,
                                       rtol=1e-12)


def test_replays_by_stage(served):
    """Replays follow the schedule, and again after ``reset()``; the host
    spans nest: a replay inside its step."""
    assert served["stages"] == 2 * SCHEDULE
    want = {"g0": 1, "g1": 1, "g2": 1, "g3": 1, "steady": 2}
    assert served["replays"] == [want, {k: 2 * v for k, v in want.items()}]
    records = served["bundle"].records
    spans = records.host_spans()
    assert len(spans) == 2 * len(SCHEDULE)
    assert (np.diff(spans, axis=1) >= 0).all()
    assert (spans[1:, 0] >= spans[:-1, 3]).all()
    assert len(records.host_spans("steady")) == 4
    stats = served["bundle"].stats()
    assert stats["replays"] == served["replays"][1]
    assert set(stats["host_ms"]) == set(tracing.HOST_SPANS)
    assert set(stats["device_ms"]) == set(want)


def test_outside_the_bundle_nothing_is_recorded(served):
    """The model called outside the bundle marks nothing; the bundle's
    disparities are bit-equal to ``streaming_step``'s."""
    model, records = served["model"], served["bundle"].records
    frames, K, bl, T = served["inputs"]
    before = {n: (m.newest().copy(), int(m.cursor[0]))
              for n, m in records.marks.items()}
    steps = len(records.host_spans())
    prev = initial_prev(model, 1, H, W)
    for (left, right), want in zip(frames, served["disps"]):
        out, prev = streaming_step(model, left, right, prev, K, bl, T)
        assert torch.equal(out["disps"][0], want)
    for name, marks in records.marks.items():
        assert int(marks.cursor[0]) == before[name][1]
        assert np.array_equal(marks.newest(), before[name][0])
    assert len(records.host_spans()) == steps
    assert not model._forward_pre_hooks and not model._forward_hooks


def test_rings_return_the_newest_in_order():
    """Past their slots, the rings hold the newest replays and steps,
    oldest first."""
    marks = tracing.StageMarks(True, torch.device("cpu"), slots=3)
    began = []
    for _ in range(5):
        began.append(time.perf_counter_ns())
        for point in tracing.POINTS:
            marks.mark(point)
    t = marks.newest()
    assert int(marks.cursor[0]) == 5 and t.shape == (3, len(tracing.POINTS))
    assert (np.diff(t.ravel()) >= 0).all() and t[0, 0] >= began[2]
    assert np.array_equal(marks.newest(2), t[1:])

    records = tracing.Records([("g0", False), ("steady", True)],
                              torch.device("cpu"), slots=3)
    for i, name in enumerate(["g0", "steady", "steady", "steady", "g0"]):
        records.stepped(name, 10 * i, 10 * i + 1, 10 * i + 3, 10 * i + 4)
    assert records.host_spans()[:, 0].tolist() == [20, 30, 40]
    assert records.host_spans("steady", 5)[:, 0].tolist() == [20, 30]
    assert records.host_ms("replay", "g0").tolist() == [2e-6]
    assert records.replays == {"g0": 2, "steady": 3}


def test_replays_add_their_captured_launches():
    """A capture's launches are taken back and added again by each
    replay: LAUNCHES counts what ran."""
    saved = dict(LAUNCHES)
    try:
        records = tracing.Records([("steady", True)], torch.device("cpu"))
        before = dict(LAUNCHES)
        LAUNCHES["fused_cost_base"] += 2
        LAUNCHES["softsplat"] += 1
        records.captured("steady", before)
        assert LAUNCHES == before
        assert records.launches["steady"] == {"fused_cost_base": 2,
                                              "softsplat": 1}
        for _ in range(3):
            records.stepped("steady", 0, 1, 2, 3)
        assert LAUNCHES["fused_cost_base"] == before["fused_cost_base"] + 6
        assert LAUNCHES["softsplat"] == before["softsplat"] + 3
        assert records.stats()["launches"] == LAUNCHES
    finally:
        LAUNCHES.update(saved)


def test_newest_records_outlive_their_bundle():
    model = build_model(get_cfg(opts=TINY), device="cpu", seed=4)
    bundle = StreamingBundle(bundle_meta(model, 1, H, W), model,
                             progress=lambda msg: None)
    records = bundle.records
    del bundle
    assert tracing.newest() is records
