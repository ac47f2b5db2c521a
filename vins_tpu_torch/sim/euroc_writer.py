"""Write a synthetic dataset in EuRoC directory format.

Counterpart of `vins_tpu/sim/euroc_writer.py`: renders the textured-room
proxy into the on-disk layout of a EuRoC sequence,

    <root>/mav0/cam0/data.csv + data/<t_ns>.png      (gray PNGs)
    <root>/mav0/imu0/data.csv                        (t_ns, gyro, acc)
    <root>/mav0/state_groundtruth_estimate0/data.csv (t_ns, p, q)

so that `vins_tpu_torch.run_euroc.replay` reads it as it reads the real
dataset.  The IMU and the ground truth come from
`np.random.default_rng(seed)` in the reference's order and equal its CSVs;
the pixel noise is drawn from a seeded CPU `torch.Generator` (seed + 13), as
`sim/proxy.py::proxy_inputs` draws it, not from JAX's generator.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..io.png import write_png_gray
from .proxy import BA, BG, EUROC_H, EUROC_W, TIC, euroc_camera
from .render import Room, RoomRenderer
from .synthetic import Trajectory
from .window import R_IC_FORWARD


def write_euroc_dataset(root: str, duration: float = 3.0, period: float = 16.0,
                        frame_hz: float = 10.0, imu_hz: float = 200.0, seed: int = 0,
                        imu_noise: bool = True, pix_noise: float = 2.0, tex_k: int = 96,
                        device="cuda") -> dict:
    """Render and write the sequence (frames rendered on `device`); returns
    {root, n_frames, n_imu}."""
    rng = np.random.default_rng(seed)
    traj = Trajectory.circuit(radius=4.0, period=period, height=1.0)
    renderer = RoomRenderer(euroc_camera(device=device), EUROC_H, EUROC_W,
                            room=Room.make(seed + 7, k=tex_k, device=device),
                            tic=TIC, Ric=np.asarray(R_IC_FORWARD))
    gen = torch.Generator().manual_seed(seed + 13)

    cam_dir = os.path.join(root, "mav0", "cam0")
    img_dir = os.path.join(cam_dir, "data")
    imu_dir = os.path.join(root, "mav0", "imu0")
    gt_dir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    for d in (img_dir, imu_dir, gt_dir):
        os.makedirs(d, exist_ok=True)

    t0 = 1.0
    # ---- IMU @ imu_hz with white noise + bias random walk ----------------
    dt_i = 1.0 / imu_hz
    sig_a = 0.02 * np.sqrt(imu_hz) if imu_noise else 0.0
    sig_g = 0.0017 * np.sqrt(imu_hz) if imu_noise else 0.0
    wba = 0.0004 * np.sqrt(dt_i) if imu_noise else 0.0
    wbg = 2e-5 * np.sqrt(dt_i) if imu_noise else 0.0
    ba, bg = np.array(BA), np.array(BG)
    n_imu = int(round(duration * imu_hz)) + 1
    times = [t0 + k * dt_i for k in range(n_imu)]
    a_true, w_true = traj.imu_at_times(torch.tensor(times, dtype=torch.float64),
                                       torch.tensor([0.0, 0.0, 9.81], dtype=torch.float64))
    a_true, w_true = a_true.numpy(), w_true.numpy()
    with open(os.path.join(imu_dir, "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for k, t in enumerate(times):
            ba = ba + wba * rng.standard_normal(3)
            bg = bg + wbg * rng.standard_normal(3)
            acc = a_true[k] + ba + sig_a * rng.standard_normal(3)
            gyr = w_true[k] + bg + sig_g * rng.standard_normal(3)
            f.write(f"{int(round(t * 1e9))},{gyr[0]:.9f},{gyr[1]:.9f},{gyr[2]:.9f},"
                    f"{acc[0]:.9f},{acc[1]:.9f},{acc[2]:.9f}\n")

    # ---- frames @ frame_hz ----------------------------------------------
    n_frames = int(round(duration * frame_hz))
    cam_rows, gt_rows = [], []
    for fi in range(n_frames):
        t = t0 + fi / frame_hz
        p, q = traj.pos_fn(t), traj.q(t)
        img = renderer.render_device(p, q)
        if pix_noise > 0:
            noise = pix_noise * torch.randn((EUROC_H, EUROC_W), generator=gen)
            img = torch.clamp(img + noise.to(img.device), 0.0, 255.0)
        tn = int(round(t * 1e9))
        name = f"{tn}.png"
        write_png_gray(os.path.join(img_dir, name), np.clip(img.cpu().numpy(), 0, 255))
        cam_rows.append((tn, name))
        gt_rows.append((tn, p.numpy(), q.numpy()))
    with open(os.path.join(cam_dir, "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for tn, name in cam_rows:
            f.write(f"{tn},{name}\n")
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
        for tn, p, q in gt_rows:
            f.write(f"{tn},{p[0]:.9f},{p[1]:.9f},{p[2]:.9f},"
                    f"{q[0]:.9f},{q[1]:.9f},{q[2]:.9f},{q[3]:.9f}\n")

    return {"root": root, "n_frames": n_frames, "n_imu": n_imu}
