"""The EuRoC-layout proxy: rendered frames + a noisy biased IMU.

Counterpart of `vins_tpu/sim/proxy.py`: the EuRoC cam0
calibration (config/euroc.yaml), the body-to-camera extrinsic of the proxy
runs, rendered frames of the textured room along `Trajectory.circuit`, the
ground-truth epipolar error of published tracks, the proxy `Pipeline`
(`make_pipeline`) and its end-to-end run (`run_proxy`, scored by
`ate_rmse_tum`).
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..config import VinsConfig
from ..core import nplie
from ..core.cameras import PinholeCamera
from ..pipeline import Pipeline
from .render import Room, RoomRenderer
from .synthetic import Trajectory
from .window import R_IC_FORWARD

EUROC_W, EUROC_H = 752, 480
EUROC_INTRINSICS = dict(fx=461.6, fy=460.3, cx=363.0, cy=248.1,
                        k1=-2.917e-01, k2=8.228e-02, p1=5.333e-05, p2=-1.578e-04)
TIC = (0.05, -0.02, 0.03)
BA = (0.02, -0.01, 0.015)      # true accelerometer bias of the proxy IMU
BG = (0.002, 0.003, -0.001)    # true gyroscope bias
FOCAL = 460.0
# the proxy's default scene (vins_tpu/sim/proxy.py:79-91): the circuit of
# radius 4 m and period 16 s, pixel noise σ = 2, 96 texture components, seed
# 0, a 200 Hz IMU; the pipeline publishes 10 Hz frames, the front-end cell
# tracks 20 Hz ones (HZ)
HZ, RADIUS, PERIOD, PIX_NOISE, TEX_K, SEED, IMU_HZ = 20.0, 4.0, 16.0, 2.0, 96, 0, 200.0


# The JAX proxy's room (vins_tpu/sim/proxy.py:99, seed 0: jax.random.PRNGKey(7),
# 96 components per face).  Its textures are jax.random draws, so they are
# stored; `python tests/test_torch_pose_graph.py` writes the file and that
# test holds it bitwise.  Maps the JAX package saved in the proxy
# (results/two_session_map.npz) were made in this room.
JAX_ROOM_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jax_proxy_room.npy")


def jax_proxy_room(device="cuda") -> Room:
    lo = torch.tensor((-8.0, -8.0, -2.0), device=device)
    hi = torch.tensor((8.0, 8.0, 4.0), device=device)
    return Room(lo, hi, torch.from_numpy(np.load(JAX_ROOM_FILE)).to(device))


def euroc_camera(dtype=torch.float32, device="cuda") -> PinholeCamera:
    return PinholeCamera.create(**EUROC_INTRINSICS, dtype=dtype, device=device)


class Sequence(NamedTuple):
    t: np.ndarray              # [T] frame times
    frames: list               # T tensors [H,W] float32 on the device
    R_wc: np.ndarray           # [T,3,3] camera-to-world rotations (float64)
    p_wc: np.ndarray           # [T,3] camera centres in the world


def render_sequence(n_frames: int = 60, device="cuda") -> Sequence:
    """`n_frames` frames at `HZ` of the proxy (`proxy_inputs`), with the
    camera's poses for the epipolar error of tracks."""
    inp = proxy_inputs(duration=n_frames / HZ, frame_hz=HZ, device=device)
    R_b = nplie.q2R(inp.q_gt)
    return Sequence(inp.t, inp.frames, R_b @ np.asarray(R_IC_FORWARD),
                    inp.p_gt + R_b @ np.asarray(TIC))


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


def make_pipeline(device="cuda", overlap: bool = False, cuda_graph: bool = True,
                  loop_closure: bool = True, pg_skip_first_cnt: int = 10,
                  pg_async: bool = False, gumbel=None, dtype=torch.float64,
                  **cfg_kw) -> Pipeline:
    """The proxy's Pipeline (vins_tpu/sim/proxy.py:53-76): 752×480 EuRoC
    camera, 150 features, min_dist 30, publish at 10 Hz, 256 landmark slots,
    the forward extrinsic, the reference yaml's noise densities (acc_n 0.08,
    gyr_n 0.004), 64-sample IMU intervals, a `dtype` estimator (float64 by
    default); loop closure on with the reference's MIN_LOOP_NUM 25
    (keyframe.h:16) unless `cfg_kw` says otherwise, the pose graph in line
    unless `pg_async`; serial unless `overlap`.  `cfg_kw` sets any other `VinsConfig` field;
    `gumbel` goes to the pose graph."""
    cfg = make_config(loop_closure=loop_closure, pg_skip_first_cnt=pg_skip_first_cnt,
                      pg_async=pg_async, **cfg_kw)
    return Pipeline(cfg, euroc_camera(device=device), imu_buf_len=64, dtype=dtype,
                    device=device, overlap=overlap, cuda_graph=cuda_graph, gumbel=gumbel)


def make_config(loop_closure: bool = True, pg_skip_first_cnt: int = 10,
                pg_async: bool = False, **cfg_kw) -> VinsConfig:
    """The `VinsConfig` of `make_pipeline`."""
    return VinsConfig(
        image_width=EUROC_W, image_height=EUROC_H, focal=460.0, max_cnt=150, min_dist=30,
        freq=10, max_landmarks=256, g_norm=9.81, extrinsic_R=R_IC_FORWARD,
        extrinsic_t=tuple(TIC), acc_n=0.08, gyr_n=0.004, loop_closure=loop_closure,
        pg_skip_first_cnt=pg_skip_first_cnt, min_loop_num=cfg_kw.pop("min_loop_num", 25),
        pg_async=pg_async, **cfg_kw)


class ProxyInputs(NamedTuple):
    """Everything a proxy run feeds a pipeline, in order."""

    t: np.ndarray          # [T] frame times
    frames: list           # T tensors [H,W] float32 (pixel noise included)
    p_gt: np.ndarray       # [T,3] true body positions
    q_gt: np.ndarray       # [T,4] wxyz
    imu_t: np.ndarray      # [T-1, n_sub] sample times after each frame
    acc: np.ndarray        # [T-1, n_sub, 3] noisy biased accelerometer
    gyr: np.ndarray        # [T-1, n_sub, 3] noisy biased gyroscope


def proxy_inputs(duration: float = 10.0, t0: float = 1.0, frame_hz: float = 10.0,
                 device="cuda", room: Room | None = None, period: float = PERIOD,
                 radius: float = RADIUS, imu_hz: float = IMU_HZ, seed: int = SEED,
                 imu_noise: bool = True, pix_noise: float = PIX_NOISE,
                 tex_k: int = TEX_K) -> ProxyInputs:
    """The proxy run's inputs (vins_tpu/sim/proxy.py:79-155): frames at
    `frame_hz` from t0 of the textured room (`Room.make(seed + 7, k=tex_k)`)
    along `Trajectory.circuit(radius, period)`, rendered on `device` with
    Gaussian pixel noise of σ = `pix_noise` from a CPU generator seeded
    `seed + 13` (the same noise on every device), and the IMU at `imu_hz`
    between frames with white noise and a bias random walk drawn from
    `np.random.default_rng(seed)` in the reference's order (per sample: ba
    walk, bg walk, accelerometer noise, gyroscope noise; with `imu_noise`
    off the draws are made and scaled by 0, so the sensor is exact with the
    fixed biases).  `room` replaces the port's own room (`jax_proxy_room`
    gives the JAX proxy's).  Every frame is kept: 1.44 MB each."""
    rng = np.random.default_rng(seed)
    traj = Trajectory.circuit(radius=radius, period=period, height=1.0)
    cam = euroc_camera(device=device)
    ren = RoomRenderer(cam, EUROC_H, EUROC_W, room=room or Room.make(seed + 7, k=tex_k, device=device),
                       tic=TIC, Ric=np.asarray(R_IC_FORWARD))
    gen = torch.Generator().manual_seed(seed + 13)

    # discrete sensor noise: white σ_d = n·√hz; bias random-walk step σ = w·√dt
    dt_i = 1.0 / imu_hz
    sig_a = 0.02 * np.sqrt(imu_hz) if imu_noise else 0.0
    sig_g = 0.0017 * np.sqrt(imu_hz) if imu_noise else 0.0
    wba = 0.0004 * np.sqrt(dt_i) if imu_noise else 0.0
    wbg = 2e-5 * np.sqrt(dt_i) if imu_noise else 0.0
    n_frames = int(round(duration * frame_hz))
    n_sub = int(round(imu_hz / frame_hz))
    t = t0 + np.arange(n_frames) / frame_hz
    imu_t = (t[1:] - 1.0 / frame_hz)[:, None] + np.arange(1, n_sub + 1)[None, :] * dt_i
    a_true, w_true = traj.imu_at_times(torch.from_numpy(imu_t.reshape(-1)),
                                       torch.tensor([0.0, 0.0, 9.81], dtype=torch.float64))
    a_true, w_true = a_true.numpy(), w_true.numpy()
    ba, bg = np.array(BA), np.array(BG)
    acc, gyr = np.empty_like(a_true), np.empty_like(w_true)
    for k in range(len(a_true)):
        ba += wba * rng.standard_normal(3)
        bg += wbg * rng.standard_normal(3)
        acc[k] = a_true[k] + ba + sig_a * rng.standard_normal(3)
        gyr[k] = w_true[k] + bg + sig_g * rng.standard_normal(3)

    frames, p_gt, q_gt = [], [], []
    for ti in t:
        p, q = traj.pos_fn(ti), traj.q(ti)
        img = ren.render_device(p, q)
        if pix_noise > 0:
            noise = pix_noise * torch.randn((EUROC_H, EUROC_W), generator=gen)
            img = torch.clamp(img + noise.to(device), 0.0, 255.0)
        frames.append(img)
        p_gt.append(p.numpy())
        q_gt.append(q.numpy())
    shape = (n_frames - 1, n_sub, 3)
    return ProxyInputs(t, frames, np.stack(p_gt), np.stack(q_gt), imu_t,
                       acc.reshape(shape), gyr.reshape(shape))


class ProxyRun(NamedTuple):
    t: np.ndarray        # [T] published frame times
    p_gt: np.ndarray     # [T,3]
    q_gt: np.ndarray     # [T,4] wxyz
    pipe: Pipeline
    events: list
    n_loops: int         # verified loops in the pose graph's results


def run_proxy(duration: float = 10.0, pipe: Pipeline | None = None,
              inputs: ProxyInputs | None = None, device="cuda", progress=None,
              **scene) -> ProxyRun:
    """The proxy run end to end (vins_tpu/sim/proxy.py:79-163): per frame
    the IMU samples since the last frame, then the image; at the end the
    pose-graph worker is drained, the pending 4-DoF solve forced and the
    worker stopped.  Without `inputs`, `proxy_inputs(duration, **scene)`
    makes them (`scene`: period, radius, frame_hz, imu_hz, seed, imu_noise,
    pix_noise, tex_k).  `progress(fi, n, ev)` is called every 20 frames."""
    pipe = pipe or make_pipeline(device=device)
    inp = inputs or proxy_inputs(duration=duration, device=device, **scene)
    ts, p_gt, q_gt, events = [], [], [], []
    for fi, t in enumerate(inp.t):
        if fi > 0:
            for ti, a, w in zip(inp.imu_t[fi - 1], inp.acc[fi - 1], inp.gyr[fi - 1]):
                pipe.process_imu(float(ti), a, w)
        ev = pipe.process_image(inp.frames[fi], float(t))
        if ev.get("published"):
            ts.append(float(t))
            p_gt.append(inp.p_gt[fi])
            q_gt.append(inp.q_gt[fi])
            events.append(ev)
        if progress and fi % 20 == 0:
            progress(fi, len(inp.t), ev)
    pipe.pg_join()
    pipe.shutdown()
    n_loops = sum(1 for e in pipe.pg_events if e.get("loop") is not None)
    return ProxyRun(np.asarray(ts), np.stack(p_gt), np.stack(q_gt), pipe, events, n_loops)


def ate_rmse_tum(traj_est: list, t_gt, p_gt, align: str = "se3") -> float:
    """Score a pipeline trajectory [(t, p, q)] against ground truth with the
    association and alignment of tools/evaluate_ate.py (vins_tpu/sim/
    proxy.py:166-193): SE(3) (or "4dof": yaw + translation) Umeyama without
    scale, then the RMSE of the positions."""
    if not traj_est:
        return float("nan")
    t_e = np.asarray([e[0] for e in traj_est])
    p_e = np.stack([e[1] for e in traj_est])
    j = np.clip(np.searchsorted(t_gt, t_e), 0, len(t_gt) - 1)
    ok = np.abs(t_gt[j] - t_e) <= 0.02
    P, G = p_e[ok], p_gt[j[ok]]
    if len(P) < 3:
        return float("nan")
    Pc = P - P.mean(0)
    Gc = G - G.mean(0)
    if align == "se3":
        U, S, Vt = np.linalg.svd(Gc.T @ Pc)
        D = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
        A = (U @ D @ Vt @ Pc.T).T + G.mean(0)
    else:  # 4-DoF yaw+t
        num = np.sum(Gc[:, 1] * Pc[:, 0] - Gc[:, 0] * Pc[:, 1])
        den = np.sum(Gc[:, 0] * Pc[:, 0] + Gc[:, 1] * Pc[:, 1])
        th = np.arctan2(num, den)
        c, s = np.cos(th), np.sin(th)
        A = (np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]]) @ Pc.T).T + G.mean(0)
    return float(np.sqrt(np.mean(np.sum((A - G) ** 2, axis=1))))
