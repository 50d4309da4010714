"""Experiment logging: a text log with throughput and ETA, the epoch's
error table, and a scalar sink.

Counterpart of the JAX package's ``utils/logging.py``.  ``MetricLogger``
always appends to ``metrics.jsonl``; it also writes TensorBoard events when
``torch.utils.tensorboard`` imports, and only then records images.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np


def collect_env_info() -> str:
    import torch

    lines = [f"python: {sys.version.split()[0]}",
             f"torch: {torch.__version__}",
             f"cuda: {torch.version.cuda}"]
    if torch.cuda.is_available():
        lines.append(f"devices: {torch.cuda.device_count()} x "
                     f"{torch.cuda.get_device_name(0)}")
    else:
        lines.append("devices: cpu")
    return "\n".join(lines)


def format_error_table(means: Dict[str, float]) -> str:
    """Group ``metric_disparity_{i}/{region}_{metric}`` keys into aligned
    per-map/per-region rows; keys that don't match the metric naming
    scheme are listed verbatim below the table."""
    rows: Dict[str, Dict[str, float]] = {}
    extras = {}
    for k, v in means.items():
        if "/" in k and k.startswith("metric_"):
            map_name, rest = k.split("/", 1)
            region, _, metric = rest.partition("_")
            rows.setdefault(f"{map_name[len('metric_'):]}/{region}",
                            {})[metric or region] = v
        else:
            extras[k] = v
    lines = []
    if rows:
        cols = sorted({c for r in rows.values() for c in r})
        lines.append(f"{'':28s}" + "".join(f"{c:>12s}" for c in cols))
        for name in sorted(rows):
            cells = "".join(
                f"{rows[name][c]:12.4f}" if c in rows[name] else f"{'-':>12s}"
                for c in cols)
            lines.append(f"{name:28s}" + cells)
    for k in sorted(extras):
        lines.append(f"  {k}: {extras[k]:.4f}")
    return "\n".join(lines)


class FileWriter:
    """Text log (``log.txt`` and stdout) with examples/s and ETA."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.num_total_steps: Optional[int] = None
        self.start_time = time.time()
        os.makedirs(log_dir, exist_ok=True)
        self.fp = open(os.path.join(log_dir, "log.txt"), "a")
        self.stdout(collect_env_info())

    def set_num_total_steps(self, n: int) -> None:
        self.num_total_steps = n

    def set_start_time(self, t: float) -> None:
        self.start_time = t

    def stdout(self, msg: str) -> None:
        print(msg, flush=True)
        if self.fp:
            self.fp.write(msg + "\n")
            self.fp.flush()

    def log_time(self, step: int, epoch: int, batch_idx: int,
                 batch_size: int, duration: float, loss: float) -> None:
        eps = batch_size / max(duration, 1e-9)
        msg = (f"epoch {epoch:3d} | step {step:7d} | batch {batch_idx:5d} "
               f"| examples/s: {eps:8.2f} | loss: {float(loss):.5f}")
        if self.num_total_steps:
            elapsed = time.time() - self.start_time
            done = max(step, 1)
            eta = elapsed / done * max(self.num_total_steps - done, 0)
            msg += f" | ETA: {eta / 3600:.2f}h"
        self.stdout(msg)

    def close(self) -> None:
        if self.fp:
            self.fp.close()
            self.fp = None


class MetricLogger:
    """Scalar sink: ``metrics.jsonl``, plus TensorBoard events where
    ``torch.utils.tensorboard`` imports."""

    def __init__(self, log_dir: str):
        self.tb = None
        os.makedirs(log_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:     # no tensorboard package: JSONL only
            SummaryWriter = None
        if SummaryWriter is not None:
            self.tb = SummaryWriter(log_dir)
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log_scalars(self, step: int, scalars: Dict[str, float],
                    prefix: str = "") -> None:
        record = {"step": int(step)}
        for k, v in scalars.items():
            name = prefix + k
            val = float(v)
            record[name] = val
            if self.tb is not None:
                self.tb.add_scalar(name, val, step)
        if self.jsonl is not None:
            self.jsonl.write(json.dumps(record) + "\n")
            self.jsonl.flush()

    def log_image(self, step: int, name: str, image: np.ndarray) -> None:
        """image: [H, W, 3] float in [0, 1]."""
        if self.tb is None:
            return
        self.tb.add_image(name, np.transpose(image, (2, 0, 1)), step)

    def close(self) -> None:
        if self.tb is not None:
            self.tb.close()
            self.tb = None
        if self.jsonl is not None:
            self.jsonl.close()
            self.jsonl = None
