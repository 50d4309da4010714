"""The benchmark's description, resolved by name.

``BENCHMARK.json`` at the root of the checkout names the cells; a cell's
configuration, traffic mix and metrics are files found by name under this
folder, so a new one is a new file and an entry, with no code changed:

    configs/<config name>.json     the model's options as run, its source,
                                   its limits for the check
    traffic/<traffic name>.json    the mix's parameters
    metrics/<metric name>.py       a reader: ``read(run) -> float | None``
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as fp:
        return json.load(fp)


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    """The cell named ``workload`` in ``root/BENCHMARK.json``, with its
    configuration and traffic read from their files and the metrics it
    reports; raises KeyError for an unknown name."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=w["config"],
        config=load_json(root / cfg_entry["file"]),
        traffic_name=w["traffic"],
        traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def reader(metric: str, here: Path = HERE) -> ModuleType:
    """The module of ``metrics/<metric>.py``."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"stereo_bench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
