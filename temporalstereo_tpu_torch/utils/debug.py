"""Numerical debugging and profiling hooks.

Counterpart of the JAX package's ``utils/debug.py``: opt-in checks in place
of the reference's always-on ``torch.autograd.set_detect_anomaly(True)``,
and a profiler context.

  * ``check_finite(tree)``: a 0-d bool tensor, every floating leaf finite
    (no read-back: usable inside a step);
  * ``assert_finite(tree, name)``: raises ``FloatingPointError`` naming the
    first leaf with a NaN or an infinity (reads back);
  * ``nan_guard(fn)``: runs ``fn`` so that the first operation, forward or
    backward, that puts a NaN into its output raises there, as JAX's
    ``checkify`` float checks do (every operation's output is read back:
    a debugging tool, not for timing);
  * ``trace(log_dir)``: a ``torch.profiler`` context that writes a Chrome
    trace (CPU, and the card's kernels where there is one) on exit.
"""
from __future__ import annotations

import contextlib
import functools
import os
import tempfile
from typing import Any, Callable, Iterator, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of nested dicts, lists and tuples (and their
    attributes for dataclasses), depth first."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif hasattr(tree, "__dataclass_fields__"):
        for k in tree.__dataclass_fields__:
            yield from _leaves(getattr(tree, k), f"{path}.{k}")
    else:
        yield path, tree


def _floating(x) -> bool:
    return torch.is_tensor(x) and (x.is_floating_point() or x.is_complex())


def check_finite(tree: Any, name: str = "tree") -> torch.Tensor:
    """0-d bool tensor: every floating tensor of ``tree`` is finite."""
    ok = torch.tensor(True)
    for _, leaf in _leaves(tree):
        if _floating(leaf):
            ok = ok.to(leaf.device) & torch.isfinite(leaf).all()
    return ok


def assert_finite(tree: Any, name: str = "tree") -> None:
    """Raises FloatingPointError on the first floating leaf holding a NaN
    or an infinity."""
    for path, leaf in _leaves(tree):
        if _floating(leaf) and not bool(torch.isfinite(leaf).all()):
            raise FloatingPointError(f"non-finite values in {name}{path}")


class _NaNCheck(TorchDispatchMode):
    """Raises at the first operation whose floating output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for _, leaf in _leaves(out):
            if _floating(leaf) and bool(torch.isnan(leaf).any()):
                raise FloatingPointError(f"nan generated by {func}")
        return out


def nan_guard(fn: Callable) -> Callable:
    """``fn`` with every operation it runs (a backward inside it included)
    checked for NaN outputs: raises FloatingPointError at the first."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _NaNCheck():
            return fn(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "torch-trace")):
    """Profile the block and write a Chrome trace (viewable in Perfetto or
    TensorBoard) into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
