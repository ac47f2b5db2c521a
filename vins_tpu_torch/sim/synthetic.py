"""Closed-form trajectories (`vins_tpu/sim/synthetic.py`: the poses and the
IMU they imply).

A trajectory is a world position and a body yaw-pitch-roll as analytic
functions of time, evaluated on float64 tensors; velocity, acceleration and
body rates come from `torch.func.jacfwd` over t, so the IMU is exact to
machine precision.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..core import lie


def _t(t) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float64)


class Trajectory(NamedTuple):
    """Closed-form trajectory: world position + body orientation vs time."""

    pos_fn: Callable  # t -> [3]
    ypr_fn: Callable  # t -> [3] radians (yaw, pitch, roll)

    @staticmethod
    def figure8(scale: float = 4.0, period: float = 20.0, height: float = 1.2):
        """A smooth figure-8 with bounded excitation on all axes."""
        w = 2.0 * math.pi / period

        def pos(t):
            t = _t(t)
            return torch.stack([scale * torch.sin(w * t),
                                0.5 * scale * torch.sin(2.0 * w * t),
                                height * torch.sin(3.0 * w * t) * 0.3])

        def ypr(t):
            t = _t(t)
            return torch.stack([0.6 * torch.sin(w * t),
                                0.25 * torch.sin(2.0 * w * t + 0.5),
                                0.2 * torch.sin(1.5 * w * t + 1.0)])

        return Trajectory(pos, ypr)

    @staticmethod
    def circuit(radius: float = 4.0, period: float = 30.0, height: float = 1.0):
        """A closed circuit inside the textured room (sim/render.py), facing
        along the path with small z/pitch/roll excitation; the pose repeats
        after `period` seconds."""
        w = 2.0 * math.pi / period

        def pos(t):
            t = _t(t)
            return torch.stack([radius * torch.cos(w * t),
                                radius * torch.sin(w * t),
                                height + 0.25 * torch.sin(4.0 * w * t)])

        def ypr(t):
            t = _t(t)
            return torch.stack([w * t + math.pi / 2.0 + 0.08 * torch.sin(5.0 * w * t),
                                0.12 * torch.sin(3.0 * w * t + 0.4),
                                0.10 * torch.sin(2.0 * w * t + 0.7)])

        return Trajectory(pos, ypr)

    def R(self, t):
        return lie.ypr2R(self.ypr_fn(t) * 180.0 / math.pi)

    def q(self, t):
        return lie.R2q(self.R(t))

    # -- the IMU half: derivatives by forward-mode AD over t -----------------

    def vel(self, t):
        return jacfwd(self.pos_fn)(_t(t))

    def acc_world(self, t):
        return jacfwd(jacfwd(self.pos_fn))(_t(t))

    def omega_body(self, t):
        """Body angular rate from skew(ω_b) = Rᵀ dR/dt."""
        t = _t(t)
        W = self.R(t).T @ jacfwd(self.R)(t)
        return torch.stack([W[2, 1], W[0, 2], W[1, 0]])

    def imu_at(self, t, gravity):
        """Exact accelerometer/gyro specific-force measurements."""
        a_b = self.R(t).T @ (self.acc_world(t) + torch.as_tensor(gravity, dtype=torch.float64))
        return a_b, self.omega_body(t)

    def imu_at_times(self, ts, gravity):
        """`imu_at` at every time of `ts` [T]: (acc [T,3], gyr [T,3])."""
        return vmap(lambda t: self.imu_at(t, gravity))(_t(ts))


def generate_imu_interval(traj: Trajectory, t0: float, t1: float, hz: float, gravity,
                          n_max: int, ba=None, bg=None, noise_acc: float = 0.0,
                          noise_gyr: float = 0.0, generator: torch.Generator | None = None,
                          dtype=torch.float64):
    """Sample the IMU between two frames, padded to n_max steps (on the CPU).

    Returns (dt [n_max], acc [n_max+1, 3], gyr [n_max+1, 3], mask [n_max]).
    With a `generator`, white noise of the given densities is added."""
    n = int(round((t1 - t0) * hz))
    if n > n_max:
        raise ValueError(f"{n} IMU samples do not fit n_max = {n_max}")
    ts = torch.clamp(t0 + torch.arange(n_max + 1, dtype=torch.float64) / hz, max=t1)
    a, w = traj.imu_at_times(ts, gravity)
    a, w = a.to(dtype), w.to(dtype)
    if ba is not None:
        a = a + torch.as_tensor(ba, dtype=dtype)
    if bg is not None:
        w = w + torch.as_tensor(bg, dtype=dtype)
    if generator is not None and (noise_acc > 0 or noise_gyr > 0):
        a = a + noise_acc * torch.randn(a.shape, generator=generator, dtype=dtype)
        w = w + noise_gyr * torch.randn(w.shape, generator=generator, dtype=dtype)
    dt = torch.diff(ts.to(dtype))
    mask = torch.arange(n_max) < n
    return dt, a, w, mask


def make_landmarks(generator: torch.Generator, n: int, center=(0.0, 0.0, 0.0),
                   spread=(12.0, 12.0, 4.0), dtype=torch.float64) -> torch.Tensor:
    """Random 3D points in a box (data_generator.cpp:17-23 uses ±30 m), on the CPU."""
    u = 2.0 * torch.rand((n, 3), generator=generator, dtype=dtype) - 1.0
    return torch.as_tensor(center, dtype=dtype) + u * torch.as_tensor(spread, dtype=dtype)


def project_points(p_wb, q_wb, tic, qic, points, z_min: float = 0.3, tan_fov: float = 1.0):
    """Project world points [N, 3] into the (normalized-plane) camera at a body
    pose p_wb [..., 3], q_wb [..., 4]; leading pose dims broadcast.

    Returns (pt [..., N, 2] normalized coords, valid [..., N])."""
    P_b = lie.qrotate(lie.qconj(q_wb)[..., None, :], points - p_wb[..., None, :])
    P_c = lie.qrotate(lie.qconj(qic), P_b - tic)
    z = P_c[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    pt = P_c[..., :2] / zs[..., None]
    valid = (z > z_min) & (torch.abs(pt[..., 0]) < tan_fov) & (torch.abs(pt[..., 1]) < tan_fov)
    return pt, valid


def feature_velocity(traj: Trajectory, t, tic, qic, points) -> torch.Tensor:
    """Analytic normalized-plane velocity [N, 2] of each landmark at time t
    (what undistortedPoints computes by finite differencing,
    feature_tracker.cpp:258-306)."""

    def pt_of_t(s):
        pt, _ = project_points(traj.pos_fn(s).to(points.dtype), traj.q(s).to(points.dtype),
                               tic, qic, points)
        return pt

    return jacfwd(pt_of_t)(_t(t))
