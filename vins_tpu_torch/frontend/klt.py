"""Pyramidal Lucas-Kanade optical flow, batched over features.

PyTorch counterpart of `vins_tpu/frontend/klt.py`, the replacement for
cv::calcOpticalFlowPyrLK(21×21, 3 levels) (feature_tracker.cpp:113).  All
feature slots are tracked every frame (invalid slots masked); each level
runs a fixed iteration count with an ε-freeze, and the status mirrors
OpenCV's min-eigenvalue and border checks.

`_lk_level` is the plain version of one level and `_lk_pyramid` chains it
over the levels.  `lk_pyramidal` sends the whole pyramid through
`klt_cuda.lk_pyramid`, which launches one CUDA kernel for all levels on
tensors on the card and runs `_lk_pyramid` for tensors on the CPU.  Both
take a leading stream axis (images [S,H,W], points [S,N,2]): the
multi-stream pipeline tracks S streams in one launch, where the JAX package
vmaps its kernel.
"""
from __future__ import annotations

import torch

from ..core.linalg import inv2x2
from .image import build_pyramid, edge_pad

SEARCH, TOP_SEARCH = 10, 32  # search radius below the top level, and on top


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


def level_searches(levels: int) -> tuple:
    """The search radius of each level, level 0 first: the top level starts
    from the raw previous position, so it searches ±32 px; the lower levels
    are pyramid-primed and search ±10 px."""
    return tuple(TOP_SEARCH if lvl == levels - 1 else SEARCH for lvl in range(levels))


def _lk_pyramid(pyr0, pyr1, pts, valid, g=None, win: int = 21, iters: int = 10,
                eps: float = 0.01, min_eig_thresh: float = 1e-4, searches=None):
    """All pyramid levels for all features (plain version of the kernel).

    pyr0/pyr1 are unpadded level images, level 0 first; their length is the
    number of levels.  g [N,2] is the guess at the top level (pts scaled to
    it by default) and `searches` the radius of each level
    (`level_searches`).  Returns (g [N,2] at level 0, ok [N] of every
    level).  With a leading stream axis (level images [S,H,W], pts/g
    [S,N,2], valid [S,N]) each stream runs on its own, as the kernel runs
    them: the results are [S,N,2] and [S,N]."""
    if pts.dim() == 3:
        outs = [_lk_pyramid([p[s] for p in pyr0], [p[s] for p in pyr1], pts[s], valid[s],
                            None if g is None else g[s], win, iters, eps, min_eig_thresh,
                            searches) for s in range(pts.shape[0])]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    levels = len(pyr0)
    pad = win // 2 + 2
    searches = level_searches(levels) if searches is None else searches
    g = pts / 2.0 ** (levels - 1) if g is None else g
    ok = valid
    for lvl in range(levels - 1, -1, -1):
        p0 = pts / 2.0 ** lvl
        g, ok_l = _lk_level(edge_pad(pyr0[lvl], pad), edge_pad(pyr1[lvl], pad), p0, g,
                            valid, win, iters, eps, min_eig_thresh, search=searches[lvl])
        ok = ok & ok_l
        if lvl > 0:
            g = g * 2.0
    return g, ok


def lk_pyramidal(
    img0: torch.Tensor,   # [H,W] (or [S,H,W]) previous frame (CLAHE'd, float)
    img1: torch.Tensor,   # [H,W] (or [S,H,W]) current frame
    pts: torch.Tensor,    # [N,2] (or [S,N,2]) feature positions in img0 (x, y)
    valid: torch.Tensor,  # [N] (or [S,N]) bool
    win: int = 21,
    levels: int = 3,
    iters: int = 10,
    eps: float = 0.01,
    min_eig_thresh: float = 1e-4,
    border: int = 1,
):
    """Track pts from img0 to img1.  Returns (pts1 [N,2], status [N]), with
    a leading [S] when the inputs have one (every stream in one launch).

    Status false ⇔ invalid input, degenerate gradient structure, or tracked
    out of border (inBorder, feature_tracker.cpp:5-11).  The levels search
    as `level_searches` says."""
    from .klt_cuda import lk_pyramid

    H, W = img0.shape[-2:]
    dtype = pts.dtype
    pyr0 = build_pyramid(img0.to(dtype).contiguous(), levels)
    pyr1 = build_pyramid(img1.to(dtype).contiguous(), levels)
    g, ok = lk_pyramid(pyr0, pyr1, pts.contiguous(), valid.contiguous(), None, win, iters,
                       eps, min_eig_thresh)

    # OpenCV rejects points whose integration window leaves the image; the
    # reference then applies its own 1-px inBorder test on top
    m = max(border, win // 2 + 1)
    in_border = ((g[..., 0] >= m) & (g[..., 0] < W - m)
                 & (g[..., 1] >= m) & (g[..., 1] < H - m))
    return g, ok & in_border
