"""Tests of the benchmark.  Run on the CPU with

    python -m pytest stereo_bench -q

and on a machine with a card the ``card`` tests too (they skip here)."""
import copy
import json
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny_config(name: str = "kitti2015-multi", height: int = 64,
                width: int = 128) -> dict:
    """A configuration file's content cut to the port's tiny test model
    (the miniature trunk, 8-channel stages, f32), by default at 64x128."""
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    o = cfg["options"]
    o["MODEL.BACKBONE.VARIANT"] = "tiny"
    o["TRAINER.PRECISION"] = "f32"
    for stage in ("COARSE", "FINE", "PRECISE"):
        o[f"MODEL.AGGREGATION.{stage}.C"] = 8
    cfg["height"], cfg["width"] = height, width
    return cfg


def tiny_traffic(name: str = "cams8-rate", streams: int = 2) -> dict:
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    mix["streams"] = streams
    mix["disparity_px"] = [2, 16]
    if mix["loop"] == "open":
        mix["tick_hz"] = 4.0
    mix["check_ticks"] = 2
    mix["profile_ticks"] = 2
    return mix
