"""The yardstick's counts: the kernels' bytes at the port's table's shapes,
and a frame's FLOPs counted from the reference alone."""
import json
import subprocess
import sys

import pytest

from stereo_bench import counts
from stereo_bench.conftest import HERE, tiny_config


@pytest.mark.parametrize("shape, elem, mb", [
    # PERF.md's kernel table, row 1: the stream's fine and precise stages
    ((1, 8, 48, 156, 128), 2, 36.7),
    ((1, 5, 96, 312, 128), 2, 97.4),
])
def test_cost_base_bytes_match_the_table(shape, elem, mb):
    assert round(counts.cost_base_bytes(*shape, elem) / 1e6, 1) == mb


@pytest.mark.parametrize("shape, mb", [((1, 48, 156, 7), 0.51),
                                       ((4, 40, 148, 7), 1.61)])
def test_softsplat_bytes_match_the_table(shape, mb):
    assert round(counts.softsplat_bytes(*shape) / 1e6, 2) == mb


def test_tick_bytes_of_the_flagship():
    cfg = json.loads((HERE / "configs" / "kitti2015-multi.json").read_text())
    got = counts.tick_bytes(cfg["options"], 1, 384, 1248)
    assert got["cost_base"] == (counts.cost_base_bytes(1, 8, 48, 156, 128, 2)
                                + counts.cost_base_bytes(1, 5, 96, 312, 128,
                                                         2))
    assert got["softsplat"] == counts.softsplat_bytes(1, 48, 156, 7)
    single = json.loads((HERE / "configs" / "kitti2015.json").read_text())
    got = counts.tick_bytes(single["options"], 8, 384, 1248)
    assert got["softsplat"] == 0
    assert got["cost_base"] == 8 * (
        counts.cost_base_bytes(1, 5, 48, 156, 128, 2)
        + counts.cost_base_bytes(1, 5, 96, 312, 128, 2))


def test_frame_flops_need_nothing_of_the_port():
    """Counted with the port made unimportable: the count cannot follow
    what implements the work."""
    cfg = tiny_config()
    code = (
        "import json, sys\n"
        "sys.modules['temporalstereo_tpu_torch'] = None\n"
        "from stereo_bench import counts\n"
        f"o = json.loads({json.dumps(json.dumps(cfg['options']))})\n"
        "print(counts.frame_flops(o, 64, 128))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=HERE.parent, timeout=300)
    assert out.returncode == 0, out.stderr
    flops = float(out.stdout.strip().splitlines()[-1])
    assert flops == counts.frame_flops(cfg["options"], 64, 128) > 0


def test_temporal_frame_costs_more_than_the_single_frame():
    multi, single = tiny_config(), tiny_config("kitti2015")
    assert (counts.frame_flops(multi["options"], 64, 128)
            > counts.frame_flops(single["options"], 64, 128) > 0)
