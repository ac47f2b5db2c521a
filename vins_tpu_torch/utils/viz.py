"""Debug imagery and observability outputs.

Counterpart of `vins_tpu/utils/viz.py`: host-side numpy drawing, for debug
paths only and never on the hot path:
  * track overlay       ← feature_tracker_node.cpp:167-201 (pub_match image:
                          tracked points coloured by track length)
  * loop-match image    ← keyframe.cpp:416-468 (side-by-side pair with
                          correspondence lines)
  * point cloud export  ← visualization.cpp pubPointCloud (PLY instead of a
                          ROS topic)

Every input may be a numpy array or a tensor on any device; each function
takes a tensor to the host once, and the images are the same `uint8`
arrays as the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch


def _host(x, dtype=None) -> np.ndarray:
    """`x` as a host numpy array (one device-to-host copy for a tensor)."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _to_rgb(img) -> np.ndarray:
    g = np.clip(_host(img, np.float32), 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def _disk(rgb: np.ndarray, u: float, v: float, color, r: int = 3):
    h, w, _ = rgb.shape
    x0, x1 = int(u) - r, int(u) + r + 1
    y0, y1 = int(v) - r, int(v) + r + 1
    if x0 < 0 or y0 < 0 or x1 > w or y1 > h:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    m = (yy - v) ** 2 + (xx - u) ** 2 <= r * r
    rgb[y0:y1, x0:x1][m] = color


def _line(rgb: np.ndarray, p0, p1, color):
    h, w, _ = rgb.shape
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    t = np.linspace(0.0, 1.0, n + 1)
    xs = np.clip((p0[0] + t * (p1[0] - p0[0])).astype(int), 0, w - 1)
    ys = np.clip((p0[1] + t * (p1[1] - p0[1])).astype(int), 0, h - 1)
    rgb[ys, xs] = color


def draw_track_overlay(img, uv, track_cnt, window: int = 20) -> np.ndarray:
    """Tracked features coloured by age: fresh = blue → long-lived = red
    (feature_tracker_node.cpp:183-190 uses the same len/WINDOW_SIZE ramp).
    Returns an RGB uint8 image."""
    rgb = _to_rgb(img)
    uv = _host(uv, float)
    frac = np.clip(_host(track_cnt, float) / float(window), 0.0, 1.0)
    for k in range(len(uv)):
        color = (int(255 * frac[k]), 0, int(255 * (1.0 - frac[k])))
        _disk(rgb, uv[k, 0], uv[k, 1], color)
    return rgb


def draw_loop_match(img_cur, img_old, uv_cur, uv_old, inliers=None) -> np.ndarray:
    """Side-by-side loop pair with green correspondence lines
    (KeyFrame::drawConnection and the loop_match image, keyframe.cpp:416-468)."""
    a = _to_rgb(img_cur)
    b = _to_rgb(img_old)
    h = max(a.shape[0], b.shape[0])
    out = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    out[: a.shape[0], : a.shape[1]] = a
    out[: b.shape[0], a.shape[1]:] = b
    off = a.shape[1]
    uv_cur = _host(uv_cur, float)
    uv_old = _host(uv_old, float)
    inl = np.ones(len(uv_cur), bool) if inliers is None else _host(inliers, bool)
    for k in range(len(uv_cur)):
        if not inl[k]:
            continue
        p0 = uv_cur[k]
        p1 = uv_old[k] + np.array([off, 0.0])
        _line(out, p0, p1, (0, 255, 0))
        _disk(out, p0[0], p0[1], (0, 255, 0), r=2)
        _disk(out, p1[0], p1[1], (255, 0, 0), r=2)
    return out


def write_ply(path: str, points, color=(180, 180, 180)):
    """Landmark cloud export (pubPointCloud's data, as a file)."""
    points = _host(points, float)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(points)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                "end_header\n")
        for p in points:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {color[0]} {color[1]} {color[2]}\n")


def save_pgm(path: str, img):
    """Grayscale dump without an image library (binary PGM)."""
    g = np.clip(_host(img, np.float32), 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P5\n{g.shape[1]} {g.shape[0]}\n255\n".encode())
        f.write(g.tobytes())


def save_ppm(path: str, rgb):
    """RGB dump without an image library (binary PPM)."""
    c = np.clip(_host(rgb), 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P6\n{c.shape[1]} {c.shape[0]}\n255\n".encode())
        f.write(c.tobytes())
