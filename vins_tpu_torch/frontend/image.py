"""Image-space primitives: bilinear sampling, pyramid, CLAHE.

PyTorch counterpart of `vins_tpu/frontend/image.py` (the OpenCV calls of
the reference front-end: CLAHE at feature_tracker.cpp:87-93 and the
pyrDown inside pyramidal LK at :113).  The pyramid, the padding and CLAHE
take [H,W] images or a stack [S,H,W] of independent streams' images.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample `img` [H,W] at xy [...,2] (x=col, y=row), clamped."""
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _shift_rows(x: torch.Tensor, d: int) -> torch.Tensor:
    """out[..., i, :] = x[..., i+d, :], zero-filled at the borders."""
    if d == 0:
        return x
    z = torch.zeros(x.shape[:-2] + (abs(d), x.shape[-1]), dtype=x.dtype, device=x.device)
    if d > 0:
        return torch.cat([x[..., d:, :], z], dim=-2)
    return torch.cat([z, x[..., :d, :]], dim=-2)


_PYR_TAPS = ((1 / 16.0, -2), (4 / 16.0, -1), (6 / 16.0, 0), (4 / 16.0, 1), (1 / 16.0, 2))


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """Gaussian 5×5 blur + 2× decimation (cv::pyrDown), as a separable
    5-tap stencil of shifted rows with zero padding, summed in the
    reference's order."""
    v = sum(w * _shift_rows(img, d) for w, d in _PYR_TAPS)
    vt = v.transpose(-1, -2)
    h = sum(w * _shift_rows(vt, d) for w, d in _PYR_TAPS)
    return h.transpose(-1, -2)[..., ::2, ::2].contiguous()


def build_pyramid(img: torch.Tensor, levels: int = 3):
    """List of `levels` images, level 0 = full resolution."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def edge_pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    """Replicate-pad a [H,W] image (or each of [S,H,W]) by `pad` on every
    side."""
    H, W = img.shape[-2:]
    out = F.pad(img.reshape(-1, 1, H, W), (pad, pad, pad, pad), mode="replicate")
    return out.reshape(img.shape[:-2] + (H + 2 * pad, W + 2 * pad))


def clahe(img: torch.Tensor, clip_limit: float = 3.0, tiles: int = 8,
          nbins: int = 256) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization
    (cv::createCLAHE(3.0, (8,8)), feature_tracker.cpp:87-93): per-tile
    histograms, clipped excess redistributed uniformly, and each pixel's
    mapping bilinearly interpolated between its four nearest tile LUTs.
    The histograms are one `scatter_add_` over tile-major bin indices (exact:
    float32 counts of ones; `bincount` would read its max back to the host).
    A stack [S,H,W] is equalized image by image, in the same ops."""
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    B = img[..., 0, 0].numel()  # images in the stack
    dt = torch.float32
    dev = img.device
    th, tw = H // tiles, W // tiles
    x = img[..., : th * tiles, : tw * tiles].to(dt).reshape(B, th * tiles, tw * tiles)

    bins = torch.clamp((x * (nbins / 256.0)).to(torch.int32), 0, nbins - 1).long()
    tile = ((torch.arange(th * tiles, device=dev) // th)[:, None] * tiles
            + (torch.arange(tw * tiles, device=dev) // tw)[None, :])
    tile = torch.arange(B, device=dev)[:, None, None] * (tiles * tiles) + tile
    flat = (tile * nbins + bins).reshape(-1)
    hist = torch.zeros(B * tiles * tiles * nbins, dtype=dt, device=dev)
    hist = hist.scatter_add_(0, flat, torch.ones_like(flat, dtype=dt))
    hist = hist.reshape(B * tiles * tiles, nbins)

    # clip + redistribute (OpenCV semantics: limit scaled by tile size)
    limit = max(clip_limit * th * tw / nbins, 1.0)
    excess = torch.sum(torch.clamp(hist - limit, min=0.0), dim=1, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / nbins

    cdf = torch.cumsum(hist, dim=1)
    lut = (cdf - cdf[:, :1]) / torch.clamp(cdf[:, -1:] - cdf[:, :1], min=1.0) * 255.0
    lut = lut.reshape(B, tiles, tiles, nbins)

    out = _apply_lut_gather(bins, lut, tiles, th, tw, dt)
    full = img.to(dt).clone()
    full[..., : th * tiles, : tw * tiles] = out.reshape(lead + out.shape[-2:])
    return full


def _apply_lut_gather(bins, lut, tiles, th, tw, dt):
    """Bilinear interpolation of the 4 neighbouring tile LUTs, one gather
    per pixel per corner (`_apply_lut_gather` of the reference); bins
    [B,h,w] index lut [B,tiles,tiles,nbins]."""
    dev = bins.device
    b = torch.arange(bins.shape[0], device=dev)[:, None, None]
    yy = (torch.arange(th * tiles, dtype=dt, device=dev) + 0.5) / th - 0.5
    xx = (torch.arange(tw * tiles, dtype=dt, device=dev) + 0.5) / tw - 0.5
    y0 = torch.clamp(torch.floor(yy).long(), 0, tiles - 1)
    x0 = torch.clamp(torch.floor(xx).long(), 0, tiles - 1)
    y1 = torch.clamp(y0 + 1, 0, tiles - 1)
    x1 = torch.clamp(x0 + 1, 0, tiles - 1)
    fy = torch.clamp(yy - y0, 0.0, 1.0)[:, None]
    fx = torch.clamp(xx - x0, 0.0, 1.0)[None, :]

    def g(ty, tx):
        return lut[b, ty[None, :, None], tx[None, None, :], bins]

    return (g(y0, x0) * (1 - fy) * (1 - fx) + g(y0, x1) * (1 - fy) * fx
            + g(y1, x0) * fy * (1 - fx) + g(y1, x1) * fy * fx)
