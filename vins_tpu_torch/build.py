"""Builds the port's CUDA kernels with nvcc into `build/kernels/`.

Each source in `csrc/` becomes one shared library with a plain C
interface, loaded with ctypes.  A library's file name carries a hash of its
source, so an edited source is rebuilt and a stale library is never loaded.
Builds run at first use, one nvcc per missing library.
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
KERNELS = ("lk_level",)
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


def build(name: str) -> tuple[float, str] | None:
    """Build the library of `name` unless it is built.  Returns (seconds,
    nvcc's output with the ptxas report), or None if it was already built;
    raises if nvcc fails."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return time.perf_counter() - t0, proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The built library of `name`, building it first if it is missing."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
