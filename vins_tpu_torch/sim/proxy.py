"""The EuRoC-layout proxy sequence for the front-end.

Counterpart of the camera half of `vins_tpu/sim/proxy.py`: the EuRoC cam0
calibration (config/euroc.yaml), the body-to-camera extrinsic of the proxy
runs, rendered frames of the textured room along `Trajectory.circuit`, and
the ground-truth epipolar error of published tracks.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import lie
from ..core.cameras import PinholeCamera
from .render import Room, RoomRenderer
from .synthetic import Trajectory

EUROC_W, EUROC_H = 752, 480
EUROC_INTRINSICS = dict(fx=461.6, fy=460.3, cx=363.0, cy=248.1,
                        k1=-2.917e-01, k2=8.228e-02, p1=5.333e-05, p2=-1.578e-04)
TIC = (0.05, -0.02, 0.03)
R_IC_FORWARD = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
FOCAL = 460.0
# the front-end sequence: a 20 Hz camera on the circuit of the JAX proxy runs
# (sim/proxy.py: radius 4 m, period 16 s), pixel noise σ = 2
HZ, RADIUS, PERIOD, PIX_NOISE, TEX_K, SEED = 20.0, 4.0, 16.0, 2.0, 96, 0


def euroc_camera(dtype=torch.float32, device="cuda") -> PinholeCamera:
    return PinholeCamera.create(**EUROC_INTRINSICS, dtype=dtype, device=device)


class Sequence(NamedTuple):
    t: np.ndarray              # [T] frame times
    frames: list               # T tensors [H,W] float32 on the device
    R_wc: np.ndarray           # [T,3,3] camera-to-world rotations (float64)
    p_wc: np.ndarray           # [T,3] camera centres in the world


def render_sequence(n_frames: int = 60, device="cuda") -> Sequence:
    """`n_frames` frames at `HZ` of the textured room along
    `Trajectory.circuit`, through the EuRoC camera, plus Gaussian pixel noise
    σ = `PIX_NOISE` from a seeded CPU generator (the same noise on every
    device).  Starts at t = 1 s, as the JAX proxy does."""
    cam = euroc_camera(device=device)
    ren = RoomRenderer(cam, EUROC_H, EUROC_W, room=Room.make(SEED + 7, k=TEX_K, device=device),
                       tic=TIC, Ric=np.asarray(R_IC_FORWARD))
    traj = Trajectory.circuit(radius=RADIUS, period=PERIOD, height=1.0)
    gen = torch.Generator().manual_seed(SEED + 13)
    Ric = np.asarray(R_IC_FORWARD)
    ts, frames, Rs, ps = [], [], [], []
    for i in range(n_frames):
        t = 1.0 + i / HZ
        p, q = traj.pos_fn(t), traj.q(t)
        noise = PIX_NOISE * torch.randn((EUROC_H, EUROC_W), generator=gen)
        img = torch.clamp(ren.render_device(p, q) + noise.to(device), 0.0, 255.0)
        R_b = lie.q2R(q).numpy()
        ts.append(t)
        frames.append(img)
        Rs.append(R_b @ Ric)
        ps.append(p.numpy() + R_b @ np.asarray(TIC))
    return Sequence(np.asarray(ts), frames, np.stack(Rs), np.stack(ps))


def epipolar_errors_px(seq: Sequence, i: int, j: int, x_i: np.ndarray,
                       x_j: np.ndarray) -> np.ndarray:
    """Sampson distance, in pixels at the virtual focal, of normalized-plane
    correspondences x_i ↔ x_j [K,2] between frames i and j under the true
    relative pose of the camera."""
    R = seq.R_wc[j].T @ seq.R_wc[i]                  # X_j = R X_i + t
    t = seq.R_wc[j].T @ (seq.p_wc[i] - seq.p_wc[j])
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = tx @ R
    h1 = np.concatenate([x_i, np.ones((len(x_i), 1))], 1)
    h2 = np.concatenate([x_j, np.ones((len(x_j), 1))], 1)
    Ex1 = h1 @ E.T
    Etx2 = h2 @ E
    num = np.sum(h2 * Ex1, 1) ** 2
    den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
    return FOCAL * np.sqrt(num / np.maximum(den, 1e-30))


def track_quality(seq: Sequence, published: dict) -> dict:
    """Per-frame published counts and the epipolar error of every track
    published in two consecutive published frames.  `published` maps frame
    index → FrameFeatures."""
    idx = sorted(published)
    counts = [len(published[k].ids) for k in idx]
    errs = []
    for a, b in zip(idx[:-1], idx[1:]):
        fa, fb = published[a], published[b]
        common, ia, ib = np.intersect1d(fa.ids, fb.ids, return_indices=True)
        if len(common):
            errs.append(epipolar_errors_px(seq, a, b, fa.pts[ia], fb.pts[ib]))
    e = np.concatenate(errs) if errs else np.zeros(0)
    return dict(frames=idx, counts=counts, mean_count=float(np.mean(counts[1:])),
                min_count=int(np.min(counts[1:])), n_pairs=int(e.size),
                sampson_median_px=float(np.median(e)),
                sampson_p90_px=float(np.percentile(e, 90)),
                frac_over_1px=float(np.mean(e > 1.0)))
