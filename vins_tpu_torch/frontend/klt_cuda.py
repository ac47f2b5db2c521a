"""Wrappers of the hand-written CUDA kernels for pyramidal LK.

Both replace `vins_tpu/frontend/klt_pallas.py::lk_level_pallas`.
`lk_pyramid` (`csrc/lk_pyramid.cu`) runs every level in one launch and
holds the semantics of `klt._lk_pyramid`; the main path
(`klt.lk_pyramidal`) goes through it, for one stream or, with a leading
stream axis, for all S streams of the multi-stream pipeline in one launch.  `lk_level` (`csrc/lk_level.cu`) runs
one level per launch and holds those of `klt._lk_level`; it is off the main
path, kept as the baseline that `chip_smoke.py` times the new kernel
against.  A call on CPU tensors runs the plain version; a call on CUDA
tensors launches the kernel or raises.  A library is built with nvcc at
first use (`vins_tpu_torch/build.py`).
"""
from __future__ import annotations

import ctypes

import torch

from .klt import _lk_level, _lk_pyramid, level_searches, lk_search_radius

_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
WARPS_PER_BLOCK = 1   # features per block of lk_pyramid (chip_smoke times 1, 2, 4, 8)


def _check_tensors(kernel: str, dev, checks) -> None:
    """Raises unless each (tensor, dtype, shape) of `checks` is a contiguous
    tensor of that dtype and shape on `dev`."""
    for t, dt, shape in checks:
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"{kernel}: expected contiguous {dt} {shape} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")


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
        _check_tensors("lk_level", img0p.device, checks)
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


class LKPyramid:
    """`lk_pyramid(pyr0, pyr1, pts, valid, g=None, ...)` → (g [N,2], ok [N]),
    the arguments and results of `klt._lk_pyramid`: unpadded level images,
    level 0 first, as many as the levels to run (one level on its own is a
    one-element list with its guess `g`).  With a leading stream axis
    (level images [S,H,W], pts/g [S,N,2], valid [S,N]) every stream runs in
    the same launch → ([S,N,2], [S,N]).

    `launches` counts kernel launches (not plain-version calls): one per
    call, whatever S."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def _library(self):
        if self._lib is None:
            from .. import build

            lib = build.load("lk_pyramid")
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            pp, pi = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
            pl = ctypes.POINTER(ctypes.c_longlong)
            for fn in (lib.lk_pyramid_launch, lib.lk_pyramid_floor_launch):
                fn.argtypes = [pp, pp, pl, pi, pi, pi, ci, ci, vp, vp, vp, ci, ci, cf, cf, vp,
                               vp, vp, ci, vp]
                fn.restype = ci
            for fn in (lib.lk_pyramid_win, lib.lk_pyramid_max_levels, lib.lk_pyramid_max_warps):
                fn.argtypes = []
                fn.restype = ci
            lib.lk_pyramid_smem_bytes.argtypes = [ci, ci]
            lib.lk_pyramid_smem_bytes.restype = ctypes.c_size_t
            self._lib = lib
        return self._lib

    def __call__(self, pyr0, pyr1, pts, valid, g=None, win: int = 21, iters: int = 10,
                 eps: float = 0.01, min_eig_thresh: float = 1e-4, searches=None):
        if pts.device.type == "cpu":
            return _lk_pyramid(pyr0, pyr1, pts, valid, g, win, iters, eps, min_eig_thresh,
                               searches)
        return self.launch(pyr0, pyr1, pts, valid, g, win, iters, eps, min_eig_thresh,
                           searches)

    def launch(self, pyr0, pyr1, pts, valid, g=None, win: int = 21, iters: int = 10,
               eps: float = 0.01, min_eig_thresh: float = 1e-4, searches=None, *,
               trace=None, warps_per_block: int = WARPS_PER_BLOCK, floor: bool = False):
        """Launches the kernel.  `trace`, a float32 [N, levels, 4] CUDA
        tensor ([S, N, levels, 4] with a stream axis), receives per feature
        and level the level's result g (before the doubling to the next
        level), its ok and the steps it ran.  `floor` launches an empty
        kernel of the same grid, block, shared memory and argument instead
        (the launch floor), which is not counted."""
        dev = pts.device
        if dev.type != "cuda":
            raise ValueError(f"lk_pyramid kernel needs CUDA tensors, got {dev}")
        lib = self._library()
        batched = pts.dim() == 3
        lead = tuple(pts.shape[:1]) if batched else ()  # (S,) or ()
        S = lead[0] if batched else 1
        levels, N = len(pyr0), pts.shape[-2]
        if not 1 <= levels <= lib.lk_pyramid_max_levels() or len(pyr1) != levels:
            raise ValueError(f"lk_pyramid: {levels} / {len(pyr1)} levels, at most "
                             f"{lib.lk_pyramid_max_levels()}, as many in both pyramids")
        if win != lib.lk_pyramid_win():
            raise ValueError(f"lk_pyramid: the kernel is built for win {lib.lk_pyramid_win()}, "
                             f"got {win}")
        if not 1 <= warps_per_block <= lib.lk_pyramid_max_warps():
            raise ValueError(f"lk_pyramid: warps_per_block {warps_per_block} out of range")
        searches = level_searches(levels) if searches is None else searches
        pad = win // 2 + 2
        if not 1 <= S <= 65535:
            raise ValueError(f"lk_pyramid: {S} streams, 1 to 65535")
        checks = [(pts, torch.float32, lead + (N, 2)), (valid, torch.bool, lead + (N,))]
        if g is not None:
            checks.append((g, torch.float32, lead + (N, 2)))
        if trace is not None:
            checks.append((trace, torch.float32, lead + (N, levels, 4)))
        capped = []
        for img0, img1, search in zip(pyr0, pyr1, searches, strict=True):
            H, W = img0.shape[-2:]
            checks += [(img0, torch.float32, lead + (H, W)), (img1, torch.float32, lead + (H, W))]
            capped.append(lk_search_radius(win, H + 2 * pad, W + 2 * pad, search))
            if capped[-1] < 0 or min(H, W) + 2 * pad < win + 3:
                raise ValueError(f"lk_pyramid: level {H}x{W} is smaller than the window")
        _check_tensors("lk_pyramid", dev, checks)
        g_out = torch.empty(lead + (N, 2), dtype=torch.float32, device=dev)
        ok = torch.empty(lead + (N,), dtype=torch.bool, device=dev)
        vpa, ia, la = ctypes.c_void_p * levels, ctypes.c_int * levels, ctypes.c_longlong * levels

        def ptr(t):
            return None if t is None else t.data_ptr()

        fn = lib.lk_pyramid_floor_launch if floor else lib.lk_pyramid_launch
        err = fn(vpa(*[p.data_ptr() for p in pyr0]), vpa(*[p.data_ptr() for p in pyr1]),
                 la(*[p.shape[-2] * p.shape[-1] for p in pyr0]),
                 ia(*[p.shape[-2] for p in pyr0]), ia(*[p.shape[-1] for p in pyr0]),
                 ia(*capped), levels, S, pts.data_ptr(), ptr(g), valid.data_ptr(), N, iters,
                 eps, min_eig_thresh, g_out.data_ptr(), ok.data_ptr(), ptr(trace),
                 warps_per_block, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"lk_pyramid kernel launch failed: cudaError {err}")
        if not floor:
            self.launches += 1
        return g_out, ok


lk_pyramid = LKPyramid()
