"""Package rules of the PyTorch port (temporalstereo_tpu_torch): it imports
neither JAX, flax, orbax, tensorstore, zstandard nor the JAX package, and
opens nothing of the JAX package's ``native/`` directory (its C++ lives in
the package); its entry points refuse to fall back to the CPU;
chip_smoke.py gives no result without a card."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.models import build_model

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "temporalstereo_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "temporalstereo_tpu", "orbax",
             "tensorstore", "zstandard")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def _path_strings(path):
    """String constants of a module other than docstrings."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = {id(n.value) for n in ast.walk(tree) if isinstance(n, ast.Expr)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            yield node.value


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_path_into_the_jax_native_directory(path):
    bad = [v for v in _path_strings(path)
           if v == "native" or "native/" in v or "libtsnative.so" in v]
    assert not bad, f"{path.name} names {bad}"


def test_native_sources_live_in_the_package():
    sources = sorted(p.relative_to(REPO) for p in PACKAGE.rglob("*.c*")
                     if p.suffix in (".cpp", ".cu", ".cuh"))
    assert pathlib.Path("temporalstereo_tpu_torch/data/csrc/tsnative.cpp") \
        in sources


def test_package_imports_without_jax(tmp_path):
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import temporalstereo_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(len(new))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_build_model_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_cfg(opts=["MODEL.BACKBONE.VARIANT", "tiny"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    assert build_model(cfg, device="cpu").dtype == torch.bfloat16


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_gives_no_result_without_card(tmp_path, alone):
    """Without a card (and, alone, without the rest of the repo) the
    script exits non-zero and prints no result line."""
    if torch.cuda.is_available() and not alone:
        pytest.skip("a card is present: chip_smoke.py would run for real")
    script = REPO / "chip_smoke.py"
    cwd = REPO
    env = dict(os.environ)
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
        env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
