"""Synthetic end-to-end driver: feeds the Estimator exact IMU and feature
tracks from a closed-form scene, in the reference's data_generator wire
format (data_generator/src/data_generator_node.cpp:30: features published
as (id, normalized xy, velocity); IMU at a fixed rate).

Counterpart of `vins_tpu/sim/driver.py`.  The draws (the landmarks and the
pixel noise) come from explicit `torch.Generator`s, not from `jax.random`;
`convert.synthetic_driver` carries a JAX driver's landmarks over, so both
packages project the same points; `jax_driver_points` gives the JAX
driver's own (`PRNGKey(0)`), stored in `jax_driver_points.npy`.  Per frame
the IMU samples since the last frame are evaluated in one batched call
(`Trajectory.imu_at_times`) and the landmarks are projected once, on the
CPU; the estimator is fed numpy.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..core import lie
from .synthetic import Trajectory, make_landmarks, project_points
from .window import R_IC_FORWARD

# the JAX driver's landmarks (make_landmarks(PRNGKey(0), 600, ...), float64);
# `python tests/test_torch_driver.py` rewrites the file
JAX_POINTS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jax_driver_points.npy")


def jax_driver_points() -> torch.Tensor:
    """The JAX `SyntheticDriver`'s default landmarks [600, 3], float64."""
    return torch.from_numpy(np.load(JAX_POINTS_FILE))


class SimRun(NamedTuple):
    t: np.ndarray  # [T] frame times
    p_gt: np.ndarray  # [T,3] ground-truth body positions
    q_gt: np.ndarray  # [T,4]
    p_est: np.ndarray  # [T,3] newest-frame estimate after each image (NaN before init)
    q_est: np.ndarray  # [T,4]
    events: list  # per-frame diagnostics dicts


class SyntheticDriver:
    def __init__(
        self,
        n_points: int = 600,
        imu_hz: float = 200.0,
        frame_hz: float = 10.0,
        g_norm: float = 9.81,
        ba=(0.02, -0.01, 0.015),
        bg=(0.002, 0.003, -0.001),
        tic=(0.06, -0.01, 0.02),
        key: torch.Generator | None = None,
        traj: Trajectory | None = None,
    ):
        """`key` draws the landmarks (a CPU generator seeded 0 when None)."""
        f64 = torch.float64
        self.traj = traj or Trajectory.figure8()
        self.gravity = torch.tensor([0.0, 0.0, g_norm], dtype=f64)
        self.imu_hz = imu_hz
        self.frame_hz = frame_hz
        self.ba = np.asarray(ba)
        self.bg = np.asarray(bg)
        self.tic = torch.tensor(tic, dtype=f64)
        self.qic = lie.R2q(torch.tensor(R_IC_FORWARD, dtype=f64))
        key = key if key is not None else torch.Generator().manual_seed(0)
        self.points = make_landmarks(key, n_points, center=(0.0, 0.0, 0.8),
                                     spread=(12.0, 12.0, 5.0), dtype=f64)
        self.max_cnt = 150  # front-end feature budget (MAX_CNT)

    def _imu_at(self, ts: list):
        """Exact (acc [n,3], gyr [n,3]) at the sample times `ts`, as numpy."""
        a, w = self.traj.imu_at_times(torch.tensor(ts, dtype=torch.float64), self.gravity)
        return a.numpy(), w.numpy()

    def _frame_fn(self, t: float):
        tt = torch.tensor(t, dtype=torch.float64)
        p = self.traj.pos_fn(tt)
        q = self.traj.q(tt)
        pt, valid = project_points(p, q, self.tic, self.qic, self.points)
        return p, q, pt, valid

    def run(self, est, n_frames: int, t0: float = 1.0, pix_noise: float = 0.0,
            noise_key: torch.Generator | None = None) -> SimRun:
        """Drive `est` for `n_frames` frames from t0.  `noise_key` draws the
        pixel noise (σ = pix_noise on the normalized plane; a CPU generator
        seeded 0 when None)."""
        dt_f = 1.0 / self.frame_hz
        dt_i = 1.0 / self.imu_hz
        n_sub = int(round(dt_f / dt_i))
        if pix_noise > 0 and noise_key is None:
            noise_key = torch.Generator().manual_seed(0)

        ts, p_gt, q_gt, p_est, q_est, events = [], [], [], [], [], []
        t = t0
        for fi in range(n_frames):
            if fi > 0:
                # IMU samples in (t_prev, t]
                acc, gyr = self._imu_at([t - dt_f + s * dt_i for s in range(1, n_sub + 1)])
                for a, w in zip(acc, gyr):
                    est.process_imu(dt_i, a + self.ba, w + self.bg)

            p, q, pt, valid = self._frame_fn(t)
            valid = valid.numpy()
            pt = pt.numpy()
            if pix_noise > 0:
                pt = pt + pix_noise * torch.randn(pt.shape, generator=noise_key,
                                                  dtype=torch.float64).numpy()
            ids = np.nonzero(valid)[0][: self.max_cnt]
            ev = est.process_image(
                ids, pt[ids], np.zeros((len(ids), 2)), pt[ids] * 460.0, t,
            )
            events.append(ev)
            ts.append(t)
            p_gt.append(p.numpy())
            q_gt.append(q.numpy())
            if est.solver_flag == 1:  # NON_LINEAR
                p_est.append(est.p[est.W].copy())
                q_est.append(est.q[est.W].copy())
            else:
                p_est.append(np.full(3, np.nan))
                q_est.append(np.full(4, np.nan))
            t += dt_f

        return SimRun(
            t=np.asarray(ts), p_gt=np.stack(p_gt), q_gt=np.stack(q_gt),
            p_est=np.stack(p_est), q_est=np.stack(q_est), events=events,
        )


def ate_rmse(run: SimRun, yaw_align: bool = True) -> float:
    """ATE RMSE after 4-DoF (yaw + translation) alignment — the standard VIO
    scoring (the estimator's world differs from GT by exactly yaw + t)."""
    m = ~np.isnan(run.p_est[:, 0])
    if m.sum() < 2:
        return float("inf")
    P = run.p_est[m]
    G = run.p_gt[m]
    if yaw_align:
        # optimal yaw via 2D Procrustes on xy
        Pc = P - P.mean(0)
        Gc = G - G.mean(0)
        num = np.sum(Gc[:, 1] * Pc[:, 0] - Gc[:, 0] * Pc[:, 1])
        den = np.sum(Gc[:, 0] * Pc[:, 0] + Gc[:, 1] * Pc[:, 1])
        th = np.arctan2(num, den)
        c, s = np.cos(th), np.sin(th)
        Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        P = (Rz @ Pc.T).T + G.mean(0)
        G = Gc + G.mean(0)
    e = np.linalg.norm(P - G, axis=1)
    return float(np.sqrt((e**2).mean()))
