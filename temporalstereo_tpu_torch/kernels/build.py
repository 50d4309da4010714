"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has plain C entry points and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under ``kernels/_build/``
(listed in ``.gitignore``), at first use, then loaded with ``ctypes``.  All
sources are compiled at once, one ``nvcc`` process each.  A library's file
name carries a hash of its source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source is rebuilt and an unchanged one is reused by
later processes of the same checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("fused_cost_base", "fused_cost_base_backward", "shift_1d",
           "softsplat")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_all(ptxas_info: bool = False) -> Dict[str, object]:
    """Compile every kernel whose library is missing, all in parallel.

    Returns {"seconds": wall time, "built": [names], "log": {name: nvcc
    stderr}}; ``ptxas_info`` adds ``-Xptxas -v`` (registers, spills) to the
    log.  Raises if any compilation fails.
    """
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in KERNELS:
        target = _library_path(name)
        if target.exists() and not ptxas_info:
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_info else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, target)
    log, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, err = proc.communicate()
        log[name] = (out + err).strip()
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{n}:\n{log[n]}" for n in failed))
    return {"seconds": time.perf_counter() - t0, "built": sorted(procs),
            "log": log}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _library_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
