"""Wrapper of the hand-written CUDA kernel for one LK pyramid level.

Replaces `vins_tpu/frontend/klt_pallas.py::lk_level_pallas`.  The kernel
(`csrc/lk_level.cu`) holds the semantics of `klt._lk_level`, its plain
version.  A call on CPU tensors runs the plain version; a call on CUDA
tensors launches the kernel or raises.  The library is built with nvcc at
first use (`vins_tpu_torch/build.py`).
"""
from __future__ import annotations

import ctypes

import torch

from .klt import _lk_level, lk_search_radius

_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


class LKLevel:
    """`lk_level(img0p, img1p, p0, g, valid, ...)` → (g_new [N,2], ok [N]).

    `launches` counts kernel launches (not plain-version calls)."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def _library(self):
        if self._lib is None:
            from .. import build

            lib = build.load("lk_level")
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.lk_level_launch.argtypes = [vp, vp, ci, ci, vp, vp, vp, ci, ci, ci,
                                            ci, cf, cf, vp, vp, vp]
            lib.lk_level_launch.restype = ci
            lib.lk_level_smem_bytes.argtypes = [ci, ci]
            lib.lk_level_smem_bytes.restype = ctypes.c_size_t
            self._lib = lib
        return self._lib

    def __call__(self, img0p, img1p, p0, g, valid, win: int = 21, iters: int = 10,
                 eps: float = 0.01, min_eig_thresh: float = 1e-4, search: int = 10):
        if img0p.device.type == "cpu":
            return _lk_level(img0p, img1p, p0, g, valid, win, iters, eps,
                             min_eig_thresh, search=search)
        return self.launch(img0p, img1p, p0, g, valid, win, iters, eps,
                           min_eig_thresh, search)

    def launch(self, img0p, img1p, p0, g, valid, win, iters, eps, min_eig_thresh,
               search):
        if img0p.device.type != "cuda":
            raise ValueError(f"lk_level kernel needs CUDA tensors, got {img0p.device}")
        N = p0.shape[0]
        Hp, Wp = img0p.shape
        checks = [
            (img0p, torch.float32, (Hp, Wp)), (img1p, torch.float32, (Hp, Wp)),
            (p0, torch.float32, (N, 2)), (g, torch.float32, (N, 2)),
            (valid, torch.bool, (N,)),
        ]
        for t, dt, shape in checks:
            if t.device != img0p.device or t.dtype != dt or tuple(t.shape) != shape \
                    or not t.is_contiguous():
                raise ValueError(
                    f"lk_level: expected contiguous {dt} {shape} on {img0p.device}, "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device} "
                    f"(contiguous={t.is_contiguous()})")
        search = lk_search_radius(win, Hp, Wp, search)
        if search < 0 or min(Hp, Wp) < win + 3:
            raise ValueError(f"lk_level: level {Hp}x{Wp} is smaller than the window")
        lib = self._library()
        if lib.lk_level_smem_bytes(win, search) > _SMEM_LIMIT:
            raise ValueError(f"lk_level: win {win} / search {search} exceed shared memory")
        g_out = torch.empty((N, 2), dtype=torch.float32, device=img0p.device)
        ok = torch.empty((N,), dtype=torch.bool, device=img0p.device)
        stream = torch.cuda.current_stream(img0p.device).cuda_stream
        err = lib.lk_level_launch(
            img0p.data_ptr(), img1p.data_ptr(), Hp, Wp, p0.data_ptr(), g.data_ptr(),
            valid.data_ptr(), N, win, search, iters, eps, min_eig_thresh,
            g_out.data_ptr(), ok.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"lk_level kernel launch failed: cudaError {err}")
        self.launches += 1
        return g_out, ok


lk_level = LKLevel()
