"""Builds the port's CUDA kernels with nvcc into `build/kernels/`.

Each source in `csrc/` becomes one shared library with a plain C
interface, loaded with ctypes.  A library's file name carries a hash of its
source, so an edited source is rebuilt and a stale library is never loaded.
Builds run at first use, one nvcc per missing library; `build_all` starts
them all together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
KERNELS = ("lk_level", "lk_pyramid")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    for cand in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=KERNELS) -> dict:
    """Build the libraries of `names` that are not built, one nvcc each, all
    started together.  Returns {name: (seconds, nvcc's output with the
    ptxas report), or None if it was already built}; raises if an nvcc
    fails."""
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    built = {name: None for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        built[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


def load(name: str) -> ctypes.CDLL:
    """The built library of `name`, building it first if it is missing."""
    build_all((name,))
    return ctypes.CDLL(str(library_path(name)))
