"""Chessboard corner detection for calibration input.

PyTorch counterpart of `vins_tpu/calib/chessboard.py` (the reference's
in-tree detector, camera_model/src/chessboard/Chessboard.cc) as dense image
ops on the image's device:

  1. X-corner (saddle) response over the whole image — one stencil chain,
  2. window non-max suppression + top-k,
  3. sub-pixel refinement by the gradient-orthogonality condition
     (the cv::cornerSubPix fixed point), batched over corners,
  4. grid ordering on the host (numpy): the inner-corner lattice from the
     two dominant lattice directions and a lattice→image homography.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.linalg import inv2x2
from ..frontend.image import bilinear


def xcorner_response(img: torch.Tensor) -> torch.Tensor:
    """Saddle-point response: chessboard X-corners are minima of det(Hessian)
    (strongly negative), invariant to board rotation.  Returns [H,W] with
    large positive values at X-corners.  Each stencil is a cross-correlation
    with zero "SAME" padding, as XLA's convolution is."""
    dt, dev = img.dtype, img.device
    g = torch.tensor([1.0, 4, 6, 4, 1], dtype=dt, device=dev) / 16.0
    k = g[:, None] * g[None, :]

    def conv(x, kk):
        return F.conv2d(x[None, None], kk[None, None], padding=kk.shape[-1] // 2)[0, 0]

    sm = conv(img, k)
    dxx = conv(sm, torch.tensor([[0.0, 0, 0], [1, -2, 1], [0, 0, 0]], dtype=dt, device=dev))
    dyy = conv(sm, torch.tensor([[0.0, 1, 0], [0, -2, 0], [0, 1, 0]], dtype=dt, device=dev))
    dxy = conv(sm, torch.tensor([[0.25, 0, -0.25], [0, 0, 0], [-0.25, 0, 0.25]],
                                dtype=dt, device=dev))
    return -(dxx * dyy - dxy * dxy)  # saddle ⇒ det(H) < 0


def detect_corners(img: torch.Tensor, max_pts: int, nms_rad: int = 5,
                   rel_thresh: float = 0.2):
    """Top-`max_pts` X-corners, NMS = keep only local maxima of the response
    within a (2·nms_rad+1)² window.  Of exactly tied maxima in a window the
    largest pixel index survives (its index pooled as float64, exact at any
    image size here); candidates come out by falling response, equal ones by
    rising index, as `jax.lax.top_k` orders them.  Returns (pts [max_pts, 2]
    (x, y), ok [max_pts])."""
    resp = xcorner_response(img)
    H, W = resp.shape
    w = 2 * nms_rad + 1
    mp = F.max_pool2d(resp[None, None], w, stride=1, padding=nms_rad)[0, 0]  # -inf padding
    thr = rel_thresh * torch.max(resp)
    tied = (resp >= mp) & (resp > thr)
    idx2 = torch.arange(H * W, dtype=torch.float64, device=img.device).reshape(H, W)
    ipool = F.max_pool2d(torch.where(tied, idx2, -1.0)[None, None], w, stride=1,
                         padding=nms_rad)[0, 0]
    flat = torch.where(tied & (idx2 == ipool), resp, -torch.inf).reshape(-1)
    vals, idx = torch.sort(flat, descending=True, stable=True)
    vals, idx = vals[:max_pts], idx[:max_pts]
    pts = torch.stack([idx % W, idx // W], -1).to(img.dtype)
    return pts, torch.isfinite(vals)


def subpix_refine(img: torch.Tensor, pts: torch.Tensor, win: int = 5,
                  iters: int = 4) -> torch.Tensor:
    """cv::cornerSubPix's fixed point: at a corner c, for every window pixel
    p, ∇I(p) ⊥ (p − c).  Solves the 2×2 normal equations `iters` times, all
    corners at once; a corner whose solve is not finite keeps its place."""
    dt, dev = img.dtype, img.device
    r = torch.arange(-win, win + 1, dtype=dt, device=dev)
    ox, oy = torch.meshgrid(r, r, indexing="xy")
    offs = torch.stack([ox.reshape(-1), oy.reshape(-1)], -1)  # [P, 2]
    wgt = torch.exp(-(ox ** 2 + oy ** 2).reshape(-1) / (2.0 * (win / 2.0) ** 2))
    dx = torch.tensor([1.0, 0.0], dtype=dt, device=dev)
    dy = torch.tensor([0.0, 1.0], dtype=dt, device=dev)
    eps = 1e-9 * torch.eye(2, dtype=dt, device=dev)
    c = pts
    for _ in range(iters):
        p = c[:, None, :] + offs  # [C, P, 2]
        gx = 0.5 * (bilinear(img, p + dx) - bilinear(img, p - dx))
        gy = 0.5 * (bilinear(img, p + dy) - bilinear(img, p - dy))
        gxx = torch.sum(wgt * gx * gx, -1)
        gxy = torch.sum(wgt * gx * gy, -1)
        gyy = torch.sum(wgt * gy * gy, -1)
        bx = torch.sum(wgt * (gx * gx * p[..., 0] + gx * gy * p[..., 1]), -1)
        by = torch.sum(wgt * (gx * gy * p[..., 0] + gy * gy * p[..., 1]), -1)
        A = torch.stack([torch.stack([gxx, gxy], -1), torch.stack([gxy, gyy], -1)], -2)
        b = torch.stack([bx, by], -1)
        c_new = (inv2x2(A + eps) @ b[..., None])[..., 0]
        c = torch.where(torch.all(torch.isfinite(c_new), -1, keepdim=True), c_new, c)
    return c


def _lattice_h(corners4: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Homography mapping lattice coords (j∈[0,cols-1], i∈[0,rows-1]) to the
    four image-space outer corners [c00, c10, c01, c11]."""
    src = np.array([[0, 0], [cols - 1, 0], [0, rows - 1], [cols - 1, rows - 1]],
                   float)
    A = []
    for (X, Y), (x, y) in zip(src, corners4):
        A.append([X, Y, 1, 0, 0, 0, -x * X, -x * Y, -x])
        A.append([0, 0, 0, X, Y, 1, -y * X, -y * Y, -y])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    return Vt[-1].reshape(3, 3)


def order_grid(pts: np.ndarray, ok: np.ndarray, rows: int, cols: int):
    """Arrange detected corners into a (rows·cols) lattice, robust to board
    rotation and perspective: take the 4 extreme detections as the outer
    lattice corners, fit the lattice→image homography, map every ideal node
    and snap it to its nearest detection (one refinement round re-fits the
    homography from all matches).  Returns (ordered [rows*cols, 2], ok)."""
    p = np.asarray(pts, float)[np.asarray(ok)]
    # dedupe: exact response ties can survive NMS and converge to the same
    # sub-pixel corner — keep the first (strongest) of any cluster within 3 px
    keep = []
    for q_ in p:
        if not keep or np.min(np.linalg.norm(np.asarray(keep) - q_, axis=-1)) > 3.0:
            keep.append(q_)
    p = np.asarray(keep)
    if len(p) < rows * cols:
        return None, False
    # keep the rows·cols strongest (candidates arrive response-ranked):
    # board-edge pseudo-corners respond measurably weaker than full saddles
    p = p[: rows * cols]
    c = p.mean(0)
    q = p - c
    _, _, Vt = np.linalg.svd(q, full_matrices=False)
    a, b = q @ Vt[0], q @ Vt[1]
    # outer lattice corners = extremes of the diagonal projections
    c00 = p[np.argmin(a + b)]
    c11 = p[np.argmax(a + b)]
    c10 = p[np.argmax(a - b)]
    c01 = p[np.argmin(a - b)]

    jj, ii = np.meshgrid(np.arange(cols), np.arange(rows))
    nodes = np.stack([jj.ravel(), ii.ravel(), np.ones(rows * cols)], -1)

    def snap(Hm):
        pr = nodes @ Hm.T
        pr = pr[:, :2] / pr[:, 2:3]
        d = np.linalg.norm(pr[:, None, :] - p[None, :, :], axis=-1)
        idx = np.argmin(d, axis=1)
        return idx, d[np.arange(len(idx)), idx]

    Hm = _lattice_h(np.stack([c00, c10, c01, c11]), rows, cols)
    idx, derr = snap(Hm)
    # refinement: re-fit the homography from all confident matches (absorbs
    # lens distortion better than the 4-corner fit)
    good = derr < np.median(derr) * 3 + 1e-9
    if good.sum() >= 8:
        A = []
        for (X, Y, _), (x, y) in zip(nodes[good], p[idx[good]]):
            A.append([X, Y, 1, 0, 0, 0, -x * X, -x * Y, -x])
            A.append([0, 0, 0, X, Y, 1, -y * X, -y * Y, -y])
        _, _, Vt2 = np.linalg.svd(np.asarray(A))
        idx, derr = snap(Vt2[-1].reshape(3, 3))
    if len(np.unique(idx)) != rows * cols:
        return None, False
    grid = p[idx].reshape(rows, cols, 2)
    # canonical orientation: row-major, first corner at min (y, x)
    if grid[0, 0, 1] > grid[-1, 0, 1]:
        grid = grid[::-1]
    if grid[0, 0, 0] > grid[0, -1, 0]:
        grid = grid[:, ::-1]
    return grid.reshape(-1, 2), True


def find_chessboard(img, rows: int, cols: int, device="cuda"):
    """Full detection (the reference's Chessboard::findCorners) of an [H, W]
    image (numpy or tensor) on `device`: returns (corners [rows*cols, 2]
    numpy, ordered row-major, ok).  The detections come to the host once,
    for `order_grid`."""
    im = torch.as_tensor(img, dtype=torch.float32, device=device)
    # over-detect: boundary-straddling corners appear twice (deduped below)
    pts, ok = detect_corners(im, max_pts=rows * cols + 16)
    pts = subpix_refine(im, pts)
    return order_grid(pts.cpu().numpy(), ok.cpu().numpy(), rows, cols)


def board_object_points(rows: int, cols: int, square: float) -> np.ndarray:
    """Board-plane coordinates of the inner-corner lattice, row-major."""
    jj, ii = np.meshgrid(np.arange(cols), np.arange(rows))
    return (np.stack([jj.ravel(), ii.ravel()], -1) * square).astype(float)
