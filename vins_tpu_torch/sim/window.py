"""A complete synthetic sliding-window problem (states + observations +
preintegrations) built directly from a closed-form scene: the solver-level
test harness and the sharded solve's workload.

Counterpart of `vins_tpu/sim/window.py`.  The scene is the reference's
(the figure-8, the forward camera, landmarks in a shell, an exact IMU at
the true biases); the draws (landmarks, pixel noise, IMU noise, the state
perturbation) come from a CPU `torch.Generator` seeded by `seed`, not from
`jax.random`, so the same seed gives the same problem on every device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import vmap

from ..core import lie
from ..imu.preintegration import ImuNoise, Preintegration, preintegrate
from ..solver.problem import FeatureObs, WindowState
from .synthetic import Trajectory, generate_imu_interval, make_landmarks, project_points

# forward-looking camera: camera z → body x (body x = forward)
R_IC_FORWARD = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))


class WindowProblem(NamedTuple):
    state_true: WindowState
    obs: FeatureObs
    pres: Preintegration
    gravity: torch.Tensor
    times: torch.Tensor
    points: torch.Tensor
    raw_dt: torch.Tensor  # [F-1, N] raw IMU buffers (for step-level consumers)
    raw_acc: torch.Tensor  # [F-1, N+1, 3]
    raw_gyr: torch.Tensor  # [F-1, N+1, 3]
    raw_mask: torch.Tensor  # [F-1, N] bool


def build_window_problem(frames: int = 11, max_landmarks: int = 64, seed: int = 0,
                         t0: float = 1.0, frame_dt: float = 0.1, imu_hz: float = 200.0,
                         noise: ImuNoise = ImuNoise(), ba=(0.02, -0.01, 0.015),
                         bg=(0.002, 0.003, -0.001), pix_noise: float = 0.0,
                         imu_noise: bool = False, dtype=torch.float64,
                         device="cuda") -> WindowProblem:
    """Exact window problem: ground-truth states, masked feature grid and
    per-interval preintegrations (linearized at the true biases).  Built on
    the CPU in float64, preintegrated in `dtype`, then moved to `device`."""
    gen = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    traj = Trajectory.figure8()
    gravity = torch.tensor([0.0, 0.0, 9.81], dtype=f64)
    tic = torch.tensor([0.06, -0.01, 0.02], dtype=f64)
    qic = lie.R2q(torch.tensor(R_IC_FORWARD, dtype=f64))
    ba_t = torch.tensor(ba, dtype=f64)
    bg_t = torch.tensor(bg, dtype=f64)

    times = t0 + torch.arange(frames, dtype=f64) * frame_dt
    p = vmap(traj.pos_fn)(times)
    q = vmap(traj.q)(times)
    v = vmap(traj.vel)(times)
    state = WindowState(p=p, q=q, v=v, ba=ba_t.repeat(frames, 1), bg=bg_t.repeat(frames, 1),
                        tic=tic, qic=qic, td=torch.zeros((), dtype=f64))

    # landmarks in a shell the forward camera actually sees
    points = make_landmarks(gen, max_landmarks, center=(0.0, 0.0, 0.8),
                            spread=(14.0, 14.0, 3.0))
    pts, valid = project_points(p, q, tic, qic, points)
    pts, valid = pts.transpose(0, 1), valid.transpose(0, 1)  # [L, F, 2], [L, F]
    if pix_noise > 0:
        pts = pts + pix_noise * torch.randn(pts.shape, generator=gen, dtype=f64)

    # anchor = first valid frame; need ≥ 2 observations to be active
    first = torch.argmax(valid.to(torch.int8), dim=1)
    active = (valid.sum(dim=1) >= 2) & (first < frames - 2)

    # ground-truth inverse depth in the anchor camera
    P_b = lie.qrotate(lie.qconj(q[first]), points - p[first])
    P_c = lie.qrotate(lie.qconj(qic), P_b - tic)
    lam = 1.0 / torch.clamp(P_c[:, 2], min=1e-3)

    obs = FeatureObs(pt=pts, vel=torch.zeros_like(pts),
                     toff=torch.zeros((max_landmarks, frames), dtype=f64), valid=valid,
                     anchor=first, inv_depth=lam, active=active)

    # the raw IMU of each interval (noise drawn interval by interval)
    n_max = int(round(frame_dt * imu_hz)) + 2
    ivs = [generate_imu_interval(
        traj, float(times[0]) + i * frame_dt, float(times[0]) + (i + 1) * frame_dt, imu_hz,
        gravity, n_max, ba=ba_t, bg=bg_t, noise_acc=noise.acc_n if imu_noise else 0.0,
        noise_gyr=noise.gyr_n if imu_noise else 0.0, generator=gen if imu_noise else None)
        for i in range(frames - 1)]
    raw_dt, raw_acc, raw_gyr, raw_mask = (torch.stack(x) for x in zip(*ivs))

    def put(x):
        return x.to(device=device, dtype=dtype if x.is_floating_point() else x.dtype)

    state, obs = WindowState(*map(put, state)), FeatureObs(*map(put, obs))
    raw = [put(x) for x in (raw_dt, raw_acc, raw_gyr, raw_mask)]
    gravity, ba_d, bg_d = put(gravity), put(ba_t), put(bg_t)
    F1 = frames - 1
    pres = preintegrate(raw[0], raw[1], raw[2], ba_d.repeat(F1, 1), bg_d.repeat(F1, 1),
                        noise, raw[3])
    return WindowProblem(state, obs, pres, gravity, put(times), put(points), *raw)


def perturb_state_by(state: WindowState, z: torch.Tensor, pos_sigma=0.05, rot_sigma=0.02,
                     vel_sigma=0.05, bias_sigma=0.005, skip_first: int = 1) -> WindowState:
    """Gaussian perturbation of window states by standard normal draws
    z [5, F, 3] (position, rotation, velocity, acc bias, gyro bias); the
    first `skip_first` frames are held."""
    F = state.p.shape[0]
    z = z.to(device=state.p.device, dtype=state.p.dtype)
    m = (torch.arange(F, device=z.device) >= skip_first).to(z.dtype)[:, None]
    dp, dth, dv, dba, dbg = (s * zi * m for s, zi in zip(
        (pos_sigma, rot_sigma, vel_sigma, bias_sigma, bias_sigma), z))
    return state._replace(p=state.p + dp, q=lie.qnormalize(lie.qmul(state.q, lie.deltaQ(dth))),
                          v=state.v + dv, ba=state.ba + dba, bg=state.bg + dbg)


def perturb_state(state: WindowState, seed: int, **sigmas) -> WindowState:
    """`perturb_state_by` with draws from a CPU generator seeded by `seed`."""
    z = torch.randn((5,) + tuple(state.p.shape), generator=torch.Generator().manual_seed(seed),
                    dtype=torch.float64)
    return perturb_state_by(state, z, **sigmas)
