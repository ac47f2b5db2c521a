"""Pyramidal Lucas-Kanade optical flow, batched over features.

PyTorch counterpart of `vins_tpu/frontend/klt.py`, the replacement for
cv::calcOpticalFlowPyrLK(21×21, 3 levels) (feature_tracker.cpp:113).  All
feature slots are tracked every frame (invalid slots masked); each level
runs a fixed iteration count with an ε-freeze, and the status mirrors
OpenCV's min-eigenvalue and border checks.

`_lk_level` is the plain version of one level.  `lk_pyramidal` sends every
level through `klt_cuda.lk_level`, which launches the CUDA kernel for
tensors on the card and runs `_lk_level` for tensors on the CPU.
"""
from __future__ import annotations

import torch

from ..core.linalg import inv2x2
from .image import build_pyramid, edge_pad


def floor_index(x: torch.Tensor) -> torch.Tensor:
    """floor(x) as an integer index.  NaN maps to 0 and junk is clamped to
    ±1e9 first, so no slot (even an invalid one) can overflow the cast; the
    kernel's `floor_idx` does the same."""
    x = torch.nan_to_num(x, nan=0.0, posinf=1e9, neginf=-1e9)
    return torch.floor(torch.clamp(x, -1e9, 1e9)).long()


def _shift_bilinear(patch: torch.Tensor, fx, fy):
    """Sample [N,P,P] patches on the unit-shifted grid: out[n,j,i] = bilinear
    value at (i + fx[n], j + fy[n]), fx,fy ∈ [0,1).  → [N,P-1,P-1]."""
    a = patch[:, :-1, :-1]
    b = patch[:, :-1, 1:]
    c = patch[:, 1:, :-1]
    d = patch[:, 1:, 1:]
    return (a * (1 - fx) * (1 - fy) + b * fx * (1 - fy)
            + c * (1 - fx) * fy + d * fx * fy)


def _patches(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, P: int):
    """[N,P,P] blocks of `img` [H,W] with top-left corners (y0, x0) [N]."""
    ar = torch.arange(P, device=img.device)
    W = img.shape[1]
    idx = (y0[:, None, None] + ar[None, :, None]) * W + (x0[:, None, None] + ar[None, None, :])
    return img.reshape(-1)[idx]


def lk_search_radius(win: int, Hp: int, Wp: int, search: int) -> int:
    """The per-level search radius, capped by the level image itself (top
    levels of small images can be smaller than the window)."""
    return min(search, (min(Hp, Wp) - (win + 1)) // 2)


def _lk_level(img0, img1, p0, g, valid, win, iters, eps, min_eig_thresh,
              search: int = 10):
    """One pyramid level for all features (plain version of the kernel).

    img0/img1 are edge-padded by `pad = win//2 + 2`; p0 [N,2] are feature
    positions and g [N,2] flow guesses, both in unpadded level coordinates.
    Per feature, a [WS,WS] search window of img1 (WS = win+1+2·search) is
    fixed around the initial guess and every iteration's patch is clamped
    inside it, so flows beyond ±search clamp silently at the window edge
    (reference behaviour).  Returns (g_new [N,2], ok [N])."""
    dtype = img0.dtype
    half = win // 2
    pad = half + 2
    Hp, Wp = img0.shape
    P0 = win + 3  # template patch: bilinear + central-difference margin
    P1 = win + 1  # iteration patch: bilinear margin
    search = lk_search_radius(win, Hp, Wp, search)
    WS = P1 + 2 * search

    # ---- template + gradients from img0 --------------------------------
    ix = floor_index(p0[:, 0])
    iy = floor_index(p0[:, 1])
    fx = (p0[:, 0] - ix.to(dtype))[:, None, None]
    fy = (p0[:, 1] - iy.to(dtype))[:, None, None]
    x0 = torch.clamp(ix - half - 1 + pad, 0, Wp - P0)
    y0 = torch.clamp(iy - half - 1 + pad, 0, Hp - P0)
    S = _shift_bilinear(_patches(img0, y0, x0, P0), fx, fy)  # [N, win+2, win+2]
    t = S[:, 1:win + 1, 1:win + 1]
    gx = 0.5 * (S[:, 1:win + 1, 2:win + 2] - S[:, 1:win + 1, 0:win])
    gy = 0.5 * (S[:, 2:win + 2, 1:win + 1] - S[:, 0:win, 1:win + 1])

    g00 = torch.sum(gx * gx, dim=(1, 2))
    g01 = torch.sum(gx * gy, dim=(1, 2))
    g11 = torch.sum(gy * gy, dim=(1, 2))
    G = torch.stack([torch.stack([g00, g01], -1), torch.stack([g01, g11], -1)], -2)
    # min eigenvalue of G, normalized per pixel (OpenCV minEigThreshold)
    tr = g00 + g11
    det = g00 * g11 - g01 * g01
    disc = torch.sqrt(torch.clamp(0.25 * tr * tr - det, min=0.0))
    min_eig = (0.5 * tr - disc) / (win * win)
    ok = (min_eig > min_eig_thresh) & valid
    Ginv = inv2x2(G + 1e-9 * torch.eye(2, dtype=dtype, device=G.device))

    # ---- one search window from img1 -----------------------------------
    wx0 = torch.clamp(floor_index(g[:, 0]) - half - search + pad, 0, Wp - WS)
    wy0 = torch.clamp(floor_index(g[:, 1]) - half - search + pad, 0, Hp - WS)

    gcur = g
    for _ in range(iters):
        u = gcur - half
        fl = torch.floor(u)
        lx = torch.clamp(floor_index(u[:, 0]) + pad - wx0, 0, WS - P1)
        ly = torch.clamp(floor_index(u[:, 1]) + pad - wy0, 0, WS - P1)
        gf = u - fl
        patch1 = _patches(img1, wy0 + ly, wx0 + lx, P1)
        d = _shift_bilinear(patch1, gf[:, 0, None, None], gf[:, 1, None, None]) - t
        b = torch.stack([torch.sum(d * gx, dim=(1, 2)), torch.sum(d * gy, dim=(1, 2))], -1)
        step = -(Ginv @ b[:, :, None])[:, :, 0]
        # ε-freeze: converged features stop updating
        move = torch.linalg.vector_norm(step, dim=-1) > eps
        gcur = gcur + torch.where((move & ok)[:, None], step, torch.zeros_like(step))
    return gcur, ok


def lk_pyramidal(
    img0: torch.Tensor,   # [H,W] previous frame (CLAHE'd, float)
    img1: torch.Tensor,   # [H,W] current frame
    pts: torch.Tensor,    # [N,2] feature positions in img0 (x, y)
    valid: torch.Tensor,  # [N] bool
    win: int = 21,
    levels: int = 3,
    iters: int = 10,
    eps: float = 0.01,
    min_eig_thresh: float = 1e-4,
    border: int = 1,
):
    """Track pts from img0 to img1.  Returns (pts1 [N,2], status [N]).

    Status false ⇔ invalid input, degenerate gradient structure, or tracked
    out of border (inBorder, feature_tracker.cpp:5-11).  The top level
    starts from the raw previous position, so it searches ±32 px; the lower
    levels are pyramid-primed and search ±10 px."""
    from .klt_cuda import lk_level

    H, W = img0.shape
    dtype = pts.dtype
    pad = win // 2 + 2
    pyr0 = [edge_pad(p, pad).contiguous() for p in build_pyramid(img0.to(dtype), levels)]
    pyr1 = [edge_pad(p, pad).contiguous() for p in build_pyramid(img1.to(dtype), levels)]

    g = pts / 2.0 ** (levels - 1)
    ok = valid
    for lvl in range(levels - 1, -1, -1):
        p0 = (pts / 2.0 ** lvl).contiguous()
        top = lvl == levels - 1
        g, ok_l = lk_level(pyr0[lvl], pyr1[lvl], p0, g.contiguous(), valid,
                           win=win, iters=iters, eps=eps,
                           min_eig_thresh=min_eig_thresh,
                           search=32 if top else 10)
        ok = ok & ok_l
        if lvl > 0:
            g = g * 2.0

    # OpenCV rejects points whose integration window leaves the image; the
    # reference then applies its own 1-px inBorder test on top
    m = max(border, win // 2 + 1)
    in_border = ((g[:, 0] >= m) & (g[:, 0] < W - m)
                 & (g[:, 1] >= m) & (g[:, 1] < H - m))
    return g, ok & in_border
