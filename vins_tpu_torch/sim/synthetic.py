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
