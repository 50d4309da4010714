"""The check tells a broken timed path from a sound one: a whole run of the
harness on the CPU at the tiny size, the card's look skipped, with the
limits of each configuration; the path broken underneath (a step that
returns its state unchanged, one that leaves its cost memory unchanged,
one that carries another stream's disparity, half of the batch left out,
the answers of two streams swapped, an answer altered) and the control in
the program's place come out not correct."""
import dataclasses

import pytest
import torch

from stereo_bench import check, serve, spec
from stereo_bench.conftest import tiny_config, tiny_traffic
from stereo_bench.run import since_start

CPU = torch.device("cpu")


def _cell(config="kitti2015-multi", traffic="cams8-rate", streams=2):
    cfg = tiny_config(config)
    limits = spec.load_json(spec.HERE / "configs" / f"{config}.json")[
        "limits"]
    cfg["limits"] = limits
    return spec.Cell("tiny", 1, config, cfg, traffic,
                     tiny_traffic(traffic, streams), [], [])


SINGLE = ("kitti2015", "cam1-flood", 1)


def _verdict(cell, seed, control=False):
    # a closed loop's ticks are the CPU's pace: a longer window, so that
    # the compared ticks fall inside it
    seconds = 1.5 if cell.traffic["loop"] == "open" else 4.0
    run, checks, start_out, inputs = serve.run_cell(
        cell, seed, seconds, False, CPU, since_start, lambda msg: None)
    assert checks and run.ticks
    numbers = check.readings(checks, start_out, inputs,
                             cell.config["options"], CPU, control=control)
    numbers = numbers["control" if control else "program"]
    return check.verdict(numbers, cell.config["limits"])[0], numbers


@pytest.mark.parametrize("cell", [(), SINGLE], ids=["multi", "single"])
def test_sound_run_is_correct(cell):
    ok, numbers = _verdict(_cell(*cell), 2 ** 33 + 1)
    assert ok, numbers


@pytest.mark.parametrize("fault", ["cost_memory", "state_disp"])
def test_state_partly_unchanged_is_not_correct(monkeypatch, fault):
    """The cost memory carried on unchanged, or another stream's disparity
    carried on, with the rest of the state sound."""
    from temporalstereo_tpu_torch.models.stereo import TemporalStereoNet

    forward = TemporalStereoNet.forward

    def broken(self, left, right, prev=None):
        out, new = forward(self, left, right, prev)
        if prev is None or new is None:
            return out, new
        if fault == "cost_memory":
            return out, dataclasses.replace(new, cost_memory=prev.cost_memory)
        return out, dataclasses.replace(new, prev_disp=new.prev_disp.flip(0))

    monkeypatch.setattr(TemporalStereoNet, "forward", broken)
    ok, numbers = _verdict(_cell(), 8)
    assert not ok, numbers


def test_state_unchanged_is_not_correct(monkeypatch):
    from temporalstereo_tpu_torch.models.stereo import TemporalStereoNet

    forward = TemporalStereoNet.forward

    def unchanged(self, left, right, prev=None):
        out, new = forward(self, left, right, prev)
        return out, (prev if prev is not None else new)

    monkeypatch.setattr(TemporalStereoNet, "forward", unchanged)
    ok, numbers = _verdict(_cell(), 5)
    assert not ok, numbers


@pytest.mark.parametrize("fault", ["half_batch", "swapped"])
def test_broken_answers_are_not_correct(monkeypatch, fault):
    from temporalstereo_tpu_torch.serving import StreamingBundle

    step = StreamingBundle.step

    def broken(self, *args):
        disp = step(self, *args).clone()
        if fault == "half_batch":
            disp[disp.shape[0] // 2:] = 0
            return disp
        return disp.flip(0)

    monkeypatch.setattr(StreamingBundle, "step", broken)
    ok, numbers = _verdict(_cell(), 6)
    assert not ok, numbers


def test_single_answer_altered_is_not_correct(monkeypatch):
    from temporalstereo_tpu_torch.serving import StreamingBundle

    step = StreamingBundle.step

    def altered(self, *args):
        return step(self, *args) * 0.5

    monkeypatch.setattr(StreamingBundle, "step", altered)
    ok, numbers = _verdict(_cell(*SINGLE), 9)
    assert not ok, numbers


@pytest.mark.parametrize("cell", [(), SINGLE], ids=["multi", "single"])
def test_control_is_not_correct(cell):
    ok, numbers = _verdict(_cell(*cell), 7, control=True)
    assert not ok, numbers
