"""Shi-Tomasi corner detection with grid non-max suppression.

PyTorch counterpart of `vins_tpu/frontend/detect.py`: the replacement for
cv::goodFeaturesToTrack(MAX_CNT, 0.01, MIN_DIST) plus the reference's mask
suppression (feature_tracker.cpp:36-69, :149), re-expressed as one winner
per MIN_DIST cell with cells at or next to a tracked feature suppressed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[i, j] = x[i+dy, j+dx], zero outside."""
    H, W = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    return xp[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]


def _conv3x3_shifted(x: torch.Tensor, k) -> torch.Tensor:
    """'SAME' 3×3 correlation as shifted adds, summed in the reference's
    order (row-major taps, zero taps skipped)."""
    out = None
    for j in range(3):
        for i in range(3):
            w = k[j][i]
            if w == 0.0:
                continue
            term = _shift2d(x, j - 1, i - 1) * w
            out = term if out is None else out + term
    return out


def shi_tomasi_response(img: torch.Tensor) -> torch.Tensor:
    """Min-eigenvalue corner response (cv::cornerMinEigenVal, Sobel 3 +
    3×3 block sum), [H,W]."""
    sx = [[-1 / 8.0, 0.0, 1 / 8.0], [-2 / 8.0, 0.0, 2 / 8.0], [-1 / 8.0, 0.0, 1 / 8.0]]
    sy = [list(r) for r in zip(*sx)]
    box = [[1.0] * 3] * 3
    gx = _conv3x3_shifted(img, sx)
    gy = _conv3x3_shifted(img, sy)
    Ixx = _conv3x3_shifted(gx * gx, box)
    Iyy = _conv3x3_shifted(gy * gy, box)
    Ixy = _conv3x3_shifted(gx * gy, box)
    tr = 0.5 * (Ixx + Iyy)
    disc = torch.sqrt(torch.clamp((0.5 * (Ixx - Iyy)) ** 2 + Ixy * Ixy, min=0.0))
    return tr - disc


def top_k_stable(x: torch.Tensor, k: int):
    """Largest k along the last dim, ties to the lower index (lax.top_k's
    order; torch.topk promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def detect_grid(
    response: torch.Tensor,        # [H,W]
    existing: torch.Tensor,        # [M,2] tracked feature positions (x, y)
    existing_valid: torch.Tensor,  # [M]
    max_new: int,
    cell: int = 30,                # MIN_DIST
    quality: float = 0.01,
    border: int = 4,
):
    """Top-`max_new` new corners: per-cell argmax, cells within one ring of an
    existing feature suppressed, response ≥ quality·global-max, ranked by
    response.  Returns (pts [max_new,2], ok [max_new])."""
    H, W = response.shape
    dev = response.device
    gh, gw = H // cell, W // cell
    r = response[: gh * cell, : gw * cell]

    ys = torch.arange(gh * cell, device=dev)
    xs = torch.arange(gw * cell, device=dev)
    bmask = ((ys[:, None] >= border) & (ys[:, None] < H - border)
             & (xs[None, :] >= border) & (xs[None, :] < W - border))
    r = torch.where(bmask, r, torch.full_like(r, -torch.inf))

    cells = r.reshape(gh, cell, gw, cell).permute(0, 2, 1, 3).reshape(gh, gw, -1)
    best_val, best = torch.max(cells, dim=-1)  # first maximum, as jnp.argmax
    by = best // cell + torch.arange(gh, device=dev)[:, None] * cell
    bx = best % cell + torch.arange(gw, device=dev)[None, :] * cell

    # occupancy: cells holding or neighbouring an existing feature.  A max
    # scatter, so a duplicate invalid slot cannot clear a valid one's cell.
    ex = torch.clamp(torch.nan_to_num(existing[:, 0] / cell).floor(), 0, gw - 1).long()
    ey = torch.clamp(torch.nan_to_num(existing[:, 1] / cell).floor(), 0, gh - 1).long()
    occ = torch.zeros(gh * gw, dtype=response.dtype, device=dev)
    occ = occ.scatter_reduce(0, ey * gw + ex, existing_valid.to(response.dtype), "amax")
    occ = F.max_pool2d(occ.reshape(1, 1, gh, gw), 3, stride=1, padding=1)[0, 0] > 0

    finite = torch.isfinite(best_val)
    thresh = quality * torch.max(torch.where(finite, best_val, torch.zeros_like(best_val)))
    good = (~occ) & (best_val > thresh) & finite

    flat_val = torch.where(good, best_val, torch.full_like(best_val, -torch.inf)).reshape(-1)
    vals, idx = top_k_stable(flat_val, max_new)
    pts = torch.stack([bx.reshape(-1)[idx], by.reshape(-1)[idx]], dim=-1).to(response.dtype)
    return pts, torch.isfinite(vals)
