"""The harness is driven by data: every cell resolves to its files by name,
a new configuration, traffic mix or metric is a new file and an entry, and
a run without a card measures nothing."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from stereo_bench import spec
from stereo_bench.conftest import HERE, tiny_config, tiny_traffic

ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_workload_resolves_by_name(workload):
    cell = spec.resolve(workload)
    assert cell.config["name"] == cell.config_name
    assert cell.traffic["loop"] in ("open", "closed")
    names = [m["name"] for m in cell.end_to_end + cell.per_layer]
    assert "setup_s" in names and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for name in names:
        assert callable(spec.reader(name).read)
    assert cell.config.get("limits"), "the check needs its limits"


def test_every_file_is_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith("stereo_bench/")
        assert (ROOT / c["file"]).is_file()
    assert BENCH["paths"] == ["stereo_bench"]


def _copy(tmp_path):
    """The folder and BENCHMARK.json in a fresh root, as a checkout holds
    them."""
    shutil.copytree(HERE, tmp_path / "stereo_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def _python(tmp_path, code, **env):
    environ = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}",
                   **env)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=tmp_path, env=environ, timeout=600)


def test_new_files_are_taken_with_no_code_change(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as files
    and entries: the run finds them by name and reports the new metric."""
    root = _copy(tmp_path)
    bench = root / "stereo_bench"
    cfg = tiny_config()
    cfg["name"] = "tiny-multi"
    (bench / "configs" / "tiny-multi.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "cams2-test.json").write_text(
        json.dumps(tiny_traffic()))
    (bench / "metrics" / "ticks_done.test.py").write_text(
        'UNIT = "ticks"\n\n\ndef read(run):\n'
        '    return float(len(run.ticks))\n')
    spec_file = json.loads((root / "BENCHMARK.json").read_text())
    spec_file["configs"].append({"name": "tiny-multi", "source": "test",
                                 "file": "stereo_bench/configs/"
                                         "tiny-multi.json", "reduced": [],
                                 "why": "test"})
    spec_file["workloads"].append({"name": "tiny.cams2.test",
                                   "config": "tiny-multi",
                                   "traffic": "cams2-test", "chips": 1,
                                   "why": "test"})
    spec_file["per_layer"].append({
        "name": "ticks_done.test", "unit": "ticks", "better": "higher",
        "source": "host_clock", "layer": "serving entry",
        "moves": "frame_latency_p95_ms", "workloads": ["tiny.cams2.test"]})
    spec_file["end_to_end"][1]["workloads"].append("tiny.cams2.test")
    (root / "BENCHMARK.json").write_text(json.dumps(spec_file))
    out = _python(root, (
        "import json, torch\n"
        "from stereo_bench import run\n"
        "args = run.parse(['--workload', 'tiny.cams2.test', '--seed', "
        "'4294967311', '--seconds', '1.5', '--trace', '1'])\n"
        "print(json.dumps(run.measure(args, torch.device('cpu'), "
        "check_device=False)))\n"
        "print(json.dumps(run.forbidden_modules()))\n"))
    assert out.returncode == 0, out.stderr[-3000:]
    result, forbidden = (json.loads(x) for x in
                         out.stdout.strip().splitlines()[-2:])
    assert result["metrics"]["ticks_done.test"]["value"] >= 1
    assert result["correct"] is True
    assert forbidden == []


def test_no_card_no_result(tmp_path):
    root = _copy(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "stereo_bench.run", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=root,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                 PYTHONPATH=str(ROOT)), timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    """A short run of the flood cell at its own size: a result, correct."""
    from stereo_bench import run

    args = run.parse(["--workload", "kitti15multi.cam1.flood", "--seed",
                      "5", "--seconds", "3", "--trace", "0"])
    result = run.measure(args, card)
    assert result["correct"], result["check"]
    assert result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
