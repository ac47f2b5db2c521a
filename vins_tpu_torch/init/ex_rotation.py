"""Online camera-IMU extrinsic rotation calibration.

PyTorch counterpart of `vins_tpu/init/ex_rotation.py`
(CalibrationExRotation, initial_ex_rotation.cpp:11-67): per frame pair the
camera rotation (essential solve) and the IMU rotation (preintegration)
constrain ric through q_bk_bk1 ⊗ q_ic = q_ic ⊗ q_ck_ck1.  Huber-weighted
4×4 blocks [Qleft(q_imu) − Qright(q_cam)] are stacked and the SVD null
vector is q_ic; accepted when the second-smallest singular value exceeds
0.25 with ≥ window pairs (:52-66).  The pair history is a fixed-size ring.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import lie


class ExRotBuffer(NamedTuple):
    q_cam: torch.Tensor  # [N,4] per-pair camera rotation (frame k ← k+1)
    q_imu: torch.Tensor  # [N,4] per-pair body rotation from preintegration
    used: torch.Tensor  # [N] bool
    head: int  # next write slot (host counter)
    ric: torch.Tensor  # [4] current estimate (identity until calibrated)

    @staticmethod
    def empty(n: int = 64, dtype=torch.float64, device="cpu") -> "ExRotBuffer":
        qid = torch.zeros((n, 4), dtype=dtype, device=device)
        qid[:, 0] = 1.0
        return ExRotBuffer(q_cam=qid, q_imu=qid.clone(),
                           used=torch.zeros((n,), dtype=torch.bool, device=device), head=0,
                           ric=qid[0].clone())


def push_pair(buf: ExRotBuffer, q_cam, q_imu) -> ExRotBuffer:
    i = buf.head % buf.used.shape[0]
    q_c, q_i, used = buf.q_cam.clone(), buf.q_imu.clone(), buf.used.clone()
    q_c[i], q_i[i], used[i:i + 1] = q_cam, q_imu, True
    return buf._replace(q_cam=q_c, q_imu=q_i, used=used, head=buf.head + 1)


def calibrate_ex_rotation(buf: ExRotBuffer, min_pairs: int = 10, sv_thresh: float = 0.25):
    """One calibration solve over the buffered pairs (:37-66).  Returns
    (q_ic, ok, buffer with the updated ric)."""
    n = buf.used.shape[0]
    # Huber weight on the angular disagreement under the current estimate
    # (:37-46): w = 1 if angle < 5°, else 5/angle(deg)
    q_pred = lie.qmul(lie.qconj(buf.ric), lie.qmul(buf.q_imu, buf.ric))
    e = lie.qmul(lie.qconj(buf.q_cam), q_pred)
    ang = 2.0 * torch.arccos(torch.clamp(torch.abs(e[:, 0]), 0.0, 1.0)) * 180.0 / math.pi
    w = torch.where(ang > 5.0, 5.0 / torch.clamp(ang, min=1e-6), 1.0) * buf.used.to(ang.dtype)

    # stacked 4N×4 system: w·(Qleft(q_imu) − Qright(q_cam)) · q_ic = 0
    A = (w[:, None, None] * (lie.Qleft(buf.q_imu) - lie.Qright(buf.q_cam))).reshape(4 * n, 4)
    _, S, Vh = torch.linalg.svd(A, full_matrices=False)
    q = Vh[3]
    q = lie.qnormalize(torch.where(q[0] >= 0, q, -q))
    ok = (S[2] > sv_thresh) & (torch.sum(buf.used) >= min_pairs)
    # ric is updated UNCONDITIONALLY (initial_ex_rotation.cpp:55), so the
    # Huber weights sharpen as pairs accumulate; `ok` only gates acceptance
    return q, ok, buf._replace(ric=q)
