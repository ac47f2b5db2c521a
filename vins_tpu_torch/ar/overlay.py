"""AR overlay: a virtual cube and world axes drawn through the estimated
camera pose, hidden behind the estimated landmark cloud.

PyTorch counterpart of `vins_tpu/ar/overlay.py` (the reference's ar_demo,
ar_demo/src/ar_demo_node.cpp: `project_object` :170, `callback` :354) as
dense fixed-shape device math on the image's device:

  * cube faces → 12 triangles → per-pixel barycentric coverage and
    interpolated depth, z-buffered with one argmin over the triangles,
  * world axes → distance-to-segment masks,
  * occlusion by the landmark cloud → each landmark's depth splatted over a
    disk into a scene z-map (a min-scatter over the square around each
    disk), and cube pixels behind it restored to the camera image.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie

# unit cube corners (±0.5), and the 6 faces as corner-index quads
_CORNERS = [[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)]
# faces: -x +x -y +y -z +z (right-handed quads)
_FACES = [[0, 1, 3, 2], [4, 6, 7, 5], [0, 4, 5, 1], [2, 3, 7, 6], [0, 2, 6, 4], [1, 5, 7, 3]]
# per-face RGB (the reference's one color per face)
_FACE_RGB = [[255, 80, 80], [180, 0, 0], [80, 255, 80], [0, 180, 0], [80, 80, 255], [0, 0, 180]]
# the 12 triangles (a, b, c corner indices; two per face) and their faces
_TRI = [[f[0], f[1], f[2]] for f in _FACES] + [[f[0], f[2], f[3]] for f in _FACES]
_TRI_FACE = list(range(6)) * 2


def _pixel_grid(H: int, W: int, device):
    """(yy, xx) integer pixel coordinates [H, W], as `jnp.mgrid[:H, :W]`."""
    return torch.meshgrid(torch.arange(H, device=device), torch.arange(W, device=device),
                          indexing="ij")


def cube_in_camera(p_wc: torch.Tensor, q_wc: torch.Tensor, center_w: torch.Tensor,
                   size: float = 0.8) -> torch.Tensor:
    """Camera-frame coordinates [8, 3] of the cube's corners.  (p_wc, q_wc) is
    the world-from-camera pose, as published on /vins_estimator/camera_pose."""
    q_cw = lie.qconj(q_wc)
    Pw = torch.tensor(_CORNERS, dtype=p_wc.dtype, device=p_wc.device) * size + center_w
    return lie.qrotate(q_cw, Pw - p_wc)


def rasterize_cube(img: torch.Tensor, corners_cam: torch.Tensor, cam, alpha: float = 0.6):
    """Draw the cube onto `img` ([H,W] gray or [H,W,3]): a z-buffer over the
    12 face triangles in one vectorized pass.  `cam` is any camera of
    `core.cameras`.  Returns ([H,W,3] float32 RGB, [H,W] cube depth, +inf
    where empty)."""
    H, W = img.shape[:2]
    dev = img.device
    rgb = (img[..., None] * torch.ones(3, dtype=img.dtype, device=dev)
           if img.dim() == 2 else img).to(torch.float32)

    uv = cam.project(corners_cam)                    # [8, 2]
    z = corners_cam[:, 2]                            # [8]
    tri = torch.tensor(_TRI, device=dev)             # [12, 3]
    pa, pb, pc = (uv[tri[:, k]] for k in range(3))   # [12, 2] each
    za, zb, zc = (z[tri[:, k]][:, None, None] for k in range(3))

    yy, xx = _pixel_grid(H, W, dev)
    p = torch.stack([xx, yy], -1).to(torch.float32)  # [H, W, 2]

    def edge(a, b):
        return ((b[:, 0] - a[:, 0])[:, None, None] * (p[None, ..., 1] - a[:, 1][:, None, None])
                - (b[:, 1] - a[:, 1])[:, None, None] * (p[None, ..., 0] - a[:, 0][:, None, None]))

    w0 = edge(pb, pc)   # [12, H, W] barycentric numerators
    w1 = edge(pc, pa)
    w2 = edge(pa, pb)
    area = w0 + w1 + w2
    safe = torch.where(torch.abs(area) < 1e-9, 1.0, area)
    b0, b1, b2 = w0 / safe, w1 / safe, w2 / safe
    inside = ((b0 >= 0) & (b1 >= 0) & (b2 >= 0)) | ((b0 <= 0) & (b1 <= 0) & (b2 <= 0))
    # a triangle only counts when fully in front of the camera
    front = (za > 0.05) & (zb > 0.05) & (zc > 0.05)
    # perspective-correct enough for an overlay: interpolate 1/z linearly
    inv_z = b0 / za + b1 / zb + b2 / zc
    depth = 1.0 / torch.clamp(inv_z, min=1e-6)
    depth = torch.where(inside & front & (torch.abs(area) > 1e-9), depth, torch.inf)

    zbuf, best = torch.min(depth, dim=0)             # the first of equal depths, as argmin
    face = torch.tensor(_TRI_FACE, device=dev)[best]
    color = torch.tensor(_FACE_RGB, dtype=torch.float32, device=dev)[face]  # [H, W, 3]
    hit = torch.isfinite(zbuf)
    # (1 − α)·rgb + α·color with one rounding of the sum, the fused
    # multiply-add that XLA emits for it (exact in float64, then rounded)
    a = torch.tensor(alpha, dtype=torch.float32, device=dev).double()
    blend = (((1 - alpha) * rgb).double() + a * color.double()).to(torch.float32)
    out = torch.where(hit[..., None], blend, rgb)
    return out, zbuf


def occlude(out: torch.Tensor, base: torch.Tensor, zbuf: torch.Tensor, lm_uv: torch.Tensor,
            lm_depth: torch.Tensor, lm_valid: torch.Tensor, radius: float = 12.0,
            margin: float = 0.3) -> torch.Tensor:
    """Hide cube pixels that fall behind the estimated landmark cloud: splat
    each valid landmark's depth over a `radius`-px disk into a scene z-map;
    where the splatted scene depth is closer than the cube (by > margin),
    restore the camera image (the reference's occlusion handling,
    ar_demo_node.cpp).  Each landmark touches only the pixels of the square
    around its disk, taken by a min-scatter in one pass for all landmarks:
    the same minimum as a dense splat over the image, in L·(2r+2)² work."""
    H, W = zbuf.shape
    dev = zbuf.device
    n = int(2 * radius) + 2  # pixels a disk can span along one axis
    ok = ((lm_valid.to(zbuf.dtype) > 0.5) & (lm_depth > 0.05)
          & torch.all(torch.isfinite(lm_uv), -1))
    uv = torch.where(ok[:, None], lm_uv, 0.0)
    k = torch.arange(n, device=dev)
    # the square's first column and row; a clamped one lies wholly off the image
    x0 = torch.clamp(torch.ceil(uv[:, 0] - radius), -W - n, 2 * W).long()
    y0 = torch.clamp(torch.ceil(uv[:, 1] - radius), -H - n, 2 * H).long()
    xx = (x0[:, None] + k)[:, None, :]  # [L, 1, n]
    yy = (y0[:, None] + k)[:, :, None]  # [L, n, 1]
    dist2 = (xx - uv[:, 0, None, None]) ** 2 + (yy - uv[:, 1, None, None]) ** 2
    inside = ((dist2 <= radius ** 2) & ok[:, None, None]
              & (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H))
    d = torch.where(inside, lm_depth.to(zbuf.dtype)[:, None, None], torch.inf)
    idx = (torch.clamp(yy, 0, H - 1) * W + torch.clamp(xx, 0, W - 1)).expand_as(d)
    scene_z = torch.full((H * W,), torch.inf, dtype=zbuf.dtype, device=dev)
    scene_z = scene_z.scatter_reduce(0, idx.reshape(-1), d.reshape(-1), reduce="amin").view(H, W)
    base_rgb = (base[..., None] * torch.ones(3, dtype=base.dtype, device=base.device)
                if base.dim() == 2 else base).to(out.dtype)
    hidden = torch.isfinite(zbuf) & (scene_z + margin < zbuf)
    return torch.where(hidden[..., None], base_rgb, out)


def draw_axes(out: torch.Tensor, p_wc: torch.Tensor, q_wc: torch.Tensor, cam,
              origin_w: torch.Tensor, length: float = 0.4, width_px: float = 1.5) -> torch.Tensor:
    """World coordinate axes at origin_w, x = red, y = green, z = blue (the
    reference's axis marker)."""
    dev = out.device
    q_cw = lie.qconj(q_wc)
    ends_w = origin_w + torch.eye(3, dtype=out.dtype, device=dev) * length
    pts_w = torch.cat([origin_w[None], ends_w], 0)
    pts_c = lie.qrotate(q_cw, pts_w - p_wc)
    uv = cam.project(pts_c)
    H, W = out.shape[:2]
    yy, xx = _pixel_grid(H, W, dev)
    p = torch.stack([xx, yy], -1).to(out.dtype)
    colors = torch.tensor([[255, 0, 0], [0, 255, 0], [0, 0, 255]], dtype=out.dtype, device=dev)

    def seg_mask(a, b, vis):
        ab = b - a
        t = torch.clamp(((p - a) * ab).sum(-1) / torch.clamp((ab * ab).sum(), min=1e-9),
                        0.0, 1.0)
        d2 = ((p - (a + t[..., None] * ab)) ** 2).sum(-1)
        return (d2 <= width_px ** 2) & vis

    img = out
    for k in range(3):
        vis = (pts_c[0, 2] > 0.05) & (pts_c[k + 1, 2] > 0.05)
        m = seg_mask(uv[0], uv[k + 1], vis)
        img = torch.where(m[..., None], colors[k], img)
    return img


class ArOverlay(NamedTuple):
    """Cube placement + camera; `render` once per frame with the estimator's
    camera pose and (optionally) its landmark cloud.  Everything runs on
    `center_w`'s device, where the camera's tensors must be too."""
    camera: object
    center_w: torch.Tensor
    size: float = 0.8

    def render(self, img, p_wc, q_wc, lm_w=None, lm_valid=None) -> torch.Tensor:
        cam = self.camera
        dev = self.center_w.device
        img = torch.as_tensor(img, device=dev)
        p_wc, q_wc = torch.as_tensor(p_wc, device=dev), torch.as_tensor(q_wc, device=dev)
        corners = cube_in_camera(p_wc, q_wc, self.center_w, self.size)
        out, zbuf = rasterize_cube(img, corners, cam)
        if lm_w is not None and lm_w.shape[0]:
            lm_c = lie.qrotate(lie.qconj(q_wc), torch.as_tensor(lm_w, device=dev) - p_wc)
            lm_uv = cam.project(lm_c)
            valid = (torch.as_tensor(lm_valid, dtype=torch.bool, device=dev)
                     if lm_valid is not None
                     else torch.ones(lm_w.shape[0], dtype=torch.bool, device=dev))
            out = occlude(out, img, zbuf, lm_uv, lm_c[:, 2], valid & (lm_c[:, 2] > 0.05))
        return draw_axes(out, p_wc, q_wc, cam, torch.zeros(3, dtype=out.dtype, device=dev))
