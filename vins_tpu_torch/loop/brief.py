"""FAST corners, BRIEF descriptors and Hamming matching, batched.

PyTorch counterpart of `vins_tpu/loop/brief.py` (the reference's
loop-closure features, pose_graph/src/keyframe.cpp:87-113: cv::FAST plus
BRIEF; HammingDis, keyframe.cpp:523-528):

  * FAST-9/16 as a dense whole-image test over the 16 ring shifts, the
    contiguous-arc test by a wrap-around cumulative sum;
  * BRIEF with the JAX package's own fixed Gaussian pattern (a numpy
    constant: a stored map's descriptors depend on it);
  * descriptors as ±1 matrices, so that Hamming distances are one matmul,
    d = (256 − a·bᵀ)/2, exact in float32 (|a·b| ≤ 256).

Ties are frequent in FAST scores (sums of pixel differences), so the top-k
is a stable descending sort (`frontend.detect.top_k_stable`), which picks
and orders ties as `jax.lax.top_k` does; `argmin`/`argmax` return the first
extreme index, as `jnp`'s do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..frontend.detect import top_k_stable
from ..frontend.image import bilinear

# 16 Bresenham circle offsets (radius 3), OpenCV order: (dy, dx)
_CIRCLE = [
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
]

BRIEF_BITS = 256
_PATCH = 24  # half-size of the BRIEF patch (48×48 like DVision)


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[i, j] = img[clip(i+dy), clip(j+dx)] (edge replication)."""
    H, W = img.shape
    y0 = torch.clamp(torch.arange(H, device=img.device) + dy, 0, H - 1)
    x0 = torch.clamp(torch.arange(W, device=img.device) + dx, 0, W - 1)
    return img[y0][:, x0]


def fast_score(img: torch.Tensor, threshold: float = 20.0, arc: int = 9) -> torch.Tensor:
    """FAST-`arc`/16 corner response [H,W]: 0 where not a corner, else the
    summed |Δ| − threshold of the ring samples past the threshold."""
    ring = torch.stack([_shift2d(img, dy, dx) for dy, dx in _CIRCLE])  # [16,H,W]
    bright = ring > img[None] + threshold
    dark = ring < img[None] - threshold

    def has_arc(mask):
        # wrap-around run of length ≥ arc: the mask twice round, then a
        # length-`arc` window sum by cumulative sums
        m2 = torch.cat([mask, mask[: arc - 1]], dim=0).to(torch.int32)
        csum = torch.cat([torch.zeros_like(m2[:1]), torch.cumsum(m2, dim=0, dtype=torch.int32)])
        runs = csum[arc:] - csum[:-arc]
        return torch.any(runs[:16] == arc, dim=0)

    is_corner = has_arc(bright) | has_arc(dark)
    terms = torch.where(bright | dark, torch.abs(ring - img[None]) - threshold, 0.0)
    score = terms[0]
    for k in range(1, 16):  # in ring order, as XLA reduces the axis
        score = score + terms[k]
    return torch.where(is_corner, score, 0.0).to(img.dtype)


def fast_detect(img: torch.Tensor, max_pts: int = 500, cell: int = 16,
                threshold: float = 20.0, border: int = 28):
    """Grid-NMS FAST detection: per-cell argmax of the score map, then the
    global top-`max_pts`.  Returns (pts [max_pts,2] (x,y), ok [max_pts])."""
    score = fast_score(img, threshold=threshold)
    H, W = score.shape
    dev = img.device
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    bmask = (((ys[:, None] >= border) & (ys[:, None] < H - border))
             & ((xs[None, :] >= border) & (xs[None, :] < W - border)))
    score = torch.where(bmask, score, 0.0)

    gh, gw = H // cell, W // cell
    s = score[: gh * cell, : gw * cell]
    cells = s.reshape(gh, cell, gw, cell).permute(0, 2, 1, 3).reshape(gh, gw, -1)
    best = torch.argmax(cells, dim=-1)
    val = torch.take_along_dim(cells, best[..., None], dim=-1)[..., 0]
    by = best // cell + torch.arange(gh, device=dev)[:, None] * cell
    bx = best % cell + torch.arange(gw, device=dev)[None, :] * cell

    flat = torch.where(val > 0, val, -torch.inf).reshape(-1)
    v, idx = top_k_stable(flat, max_pts)
    pts = torch.stack([bx.reshape(-1)[idx], by.reshape(-1)[idx]], dim=-1).to(img.dtype)
    return pts, torch.isfinite(v)


def _brief_pattern() -> np.ndarray:
    """The fixed 256-pair Gaussian test pattern (offsets ~ N(0, (patch/2.5)²),
    clipped to the patch), as `vins_tpu/loop/brief.py:105-111` draws it."""
    rng = np.random.RandomState(20250817)
    sigma = _PATCH / 2.5
    pairs = rng.randn(BRIEF_BITS, 4) * sigma
    return np.clip(pairs, -_PATCH, _PATCH).astype(np.float32)


_PATTERN = _brief_pattern()
_PATTERN_ON = {}


def _pattern(dtype, device) -> torch.Tensor:
    """`_PATTERN` on the device, copied there once."""
    key = (dtype, str(device))
    if key not in _PATTERN_ON:
        _PATTERN_ON[key] = torch.from_numpy(_PATTERN).to(device=device, dtype=dtype)
    return _PATTERN_ON[key]


def brief_describe(img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """±1 BRIEF descriptors [N,256] at pts [N,2] on a pre-smoothed image
    (`smooth_for_brief`)."""
    pat = _pattern(img.dtype, img.device)  # [256,4] (x1,y1,x2,y2)
    a = bilinear(img, pts[:, None, :] + pat[None, :, 0:2])
    b = bilinear(img, pts[:, None, :] + pat[None, :, 2:4])
    return torch.where(a < b, 1.0, -1.0).to(img.dtype)


def _shift0(x: torch.Tensor, d: int) -> torch.Tensor:
    """out[i] = x[i+d] along the first axis, zero-filled."""
    if d == 0:
        return x
    z = torch.zeros((abs(d),) + x.shape[1:], dtype=x.dtype, device=x.device)
    return torch.cat([x[d:], z]) if d > 0 else torch.cat([z, x[:d]])


def smooth_for_brief(img: torch.Tensor) -> torch.Tensor:
    """7×7 binomial smoothing (≈ the Gaussian DVision applies), separable,
    zero padding, the taps summed in the JAX package's order."""
    g = [1.0, 6.0, 15.0, 20.0, 15.0, 6.0, 1.0]
    g = [w / sum(g) for w in g]

    def pass0(x):
        out = 0
        for w, d in zip(g, range(-3, 4)):
            out = out + w * _shift0(x, d)
        return out

    return pass0(pass0(img).T).T


def hamming_matrix(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances [N,M] of ±1 descriptors: (256 − a·bᵀ)/2."""
    dots = da.to(torch.float32) @ db.to(torch.float32).T
    return 0.5 * (BRIEF_BITS - dots)


def match_descriptors(da: torch.Tensor, va: torch.Tensor, db: torch.Tensor, vb: torch.Tensor,
                      max_dist: float = 80.0, ratio: float = 0.9):
    """Best match per row of `da` in `db`: the reference's 80-bit acceptance
    (keyframe.cpp:152-171 searchByBRIEFDes) and a ratio test against the
    second best.  Returns (idx [N], ok [N])."""
    d = hamming_matrix(da, db)
    d = torch.where(vb[None, :], d, torch.inf)
    idx = torch.argmin(d, dim=1)
    best = torch.take_along_dim(d, idx[:, None], dim=1)[:, 0]
    cols = torch.arange(d.shape[1], device=d.device)
    second = torch.amin(torch.where(cols[None, :] == idx[:, None], torch.inf, d), dim=1)
    ok = va & (best < max_dist) & (best < ratio * second)
    return idx, ok
