"""Visual-inertial alignment: gyro bias, per-frame velocities, gravity, scale.

PyTorch counterpart of `vins_tpu/init/alignment.py`
(initial_aligment.cpp):
  * solve_gyro_bias       ← solveGyroscopeBias (:3-37)
  * linear_alignment      ← LinearAlignment (:125-197)
  * refine_gravity        ← RefineGravity (:55-123)
  * visual_imu_alignment  ← VisualIMUAlignment (:199-207)

Fixed-shape batched linear algebra over F frames (the window keyframes, or
the all-frames ring).  Velocities are solved in each frame's body frame;
the caller rotates them to world (estimator.cpp:421-423).  Least squares
go through QR of [A | b]: R's rows may differ in sign from another QR's,
the solution does not.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import lie
from ..core.linalg import spd_solve
from ..imu.preintegration import Preintegration


def solve_gyro_bias(q_wb, pres: Preintegration, mask=None):
    """Least-squares gyro bias from SfM-vs-preintegration rotation mismatch
    (initial_aligment.cpp:3-37): q_wb [F,4] body orientations from SfM,
    `pres` batched [F-1], mask [F-1] interval validity.  Returns dbg [3]."""
    q_ij = lie.qmul(lie.qconj(q_wb[:-1]), q_wb[1:])
    J = pres.J[:, 3:6, 12:15]  # ∂(2·vec δq)/∂bg
    err = 2.0 * lie.qmul(lie.qconj(pres.dq), q_ij)[:, 1:4]
    if mask is not None:
        m = mask.to(J.dtype)
        J = J * m[:, None, None]
        err = err * m[:, None]
    A = torch.einsum("kij,kil->jl", J, J)
    b = torch.einsum("kij,ki->j", J, err)
    return spd_solve(A + 1e-10 * torch.eye(3, dtype=A.dtype, device=A.device), b)


class AlignResult(NamedTuple):
    v_body: torch.Tensor  # [F,3] per-frame velocity in body frame
    g_c0: torch.Tensor  # [3] gravity in the SfM reference (c0) frame
    scale: torch.Tensor  # [] metric scale
    ok: torch.Tensor  # [] bool
    s_rel_sigma: torch.Tensor | float = math.inf  # [] relative 1σ of the scale


def _ls_qr(A, b, pin=None):
    """Least squares via QR of [A | b] (no AᵀA: the system mixes columns of
    very different scales).  `pin` appends unit rows on selected columns
    (masked-out velocities).  Returns (x, rel_sigma_last): the solution and
    the relative 1σ of the last unknown (the scale), from the fit residual:
    σ² = ‖Ax−b‖²/dof, cov = σ²(RᵀR)⁻¹."""
    dtype, dev = A.dtype, A.device
    n = A.shape[1]
    rows, rhs = [A], [b]
    zeros = torch.zeros((n,), dtype=dtype, device=dev)
    if pin is not None:
        rows.append(torch.diag(pin))
        rhs.append(zeros)
    # tiny column-relative ridge keeps R invertible on degenerate input
    cn = torch.sqrt(torch.clamp(torch.sum(A * A, dim=0), min=1e-12))
    eps = 1e-10 if dtype == torch.float64 else 1e-5
    rows.append(torch.diag(eps * cn))
    rhs.append(zeros)
    Af, bf = torch.cat(rows, dim=0), torch.cat(rhs)
    R = torch.linalg.qr(torch.cat([Af, bf[:, None]], dim=1), mode="r")[1]
    Rn, z, rnorm = R[:n, :n], R[:n, n], torch.abs(R[n, n])
    x = torch.linalg.solve_triangular(Rn, z[:, None], upper=True)[:, 0]
    # cov_ss = σ²·‖w‖² with Rᵀw = e_s (s = last column)
    e_s = torch.zeros((n, 1), dtype=dtype, device=dev)
    e_s[-1] = 1.0
    w = torch.linalg.solve_triangular(Rn.T, e_s, upper=False)[:, 0]
    # dof counts DATA rows (not the ridge/pin rows) against the FREE
    # parameters (pinned columns are not free)
    data_rows = torch.sum((torch.abs(A) > 0).any(dim=1))
    n_pin = 0 if pin is None else torch.sum(pin > 0)
    dof = torch.clamp(data_rows - (n - n_pin), min=1).to(dtype)
    s_sigma = torch.sqrt(rnorm * rnorm / dof) * torch.linalg.vector_norm(w)
    return x, s_sigma / torch.clamp(torch.abs(x[-1]), min=1e-12)


def _build_lin_system(R_wb, p_cam, tic, pres: Preintegration, mask=None):
    """The per-pair 6×10 blocks of LinearAlignment (:135-160) stacked into a
    dense [6(F-1), 3F+4] system.  Unknowns: [v_0..v_{F-1} body, g_c0, s/100]."""
    F = R_wb.shape[0]
    K = F - 1
    dt = pres.dt_sum
    dtype, dev = p_cam.dtype, p_cam.device
    Ri_T = R_wb[:-1].transpose(-1, -2)
    RiRj = Ri_T @ R_wb[1:]
    I3 = torch.eye(3, dtype=dtype, device=dev)

    # rows 0:3 (position): -dt·v_i + Riᵀ·dt²/2·g + Riᵀ(p_j-p_i)/100·s
    #   = dp + RiᵀRj·tic - tic
    A_vi_p = -dt[:, None, None] * I3
    A_g_p = Ri_T * (0.5 * dt ** 2)[:, None, None]
    A_s_p = torch.einsum("kij,kj->ki", Ri_T, p_cam[1:] - p_cam[:-1])[..., None] / 100.0
    b_p = pres.dp + RiRj @ tic - tic
    # rows 3:6 (velocity): -v_i + (RiᵀRj)·v_j + Riᵀ·dt·g = dv
    A_g_v = Ri_T * dt[:, None, None]

    A = torch.zeros((6 * K, 3 * F + 4), dtype=dtype, device=dev)
    b = torch.cat([b_p, pres.dv], dim=1).reshape(-1)
    for k in range(K):  # static unroll, K = window size
        r = 6 * k
        A[r:r + 3, 3 * k:3 * k + 3] = A_vi_p[k]
        A[r:r + 3, 3 * F:3 * F + 3] = A_g_p[k]
        A[r:r + 3, 3 * F + 3:] = A_s_p[k]
        A[r + 3:r + 6, 3 * k:3 * k + 3] = -I3
        A[r + 3:r + 6, 3 * k + 3:3 * k + 6] = RiRj[k]
        A[r + 3:r + 6, 3 * F:3 * F + 3] = A_g_v[k]
    if mask is not None:
        m6 = torch.repeat_interleave(mask.to(dtype), 6)
        A = A * m6[:, None]
        b = b * m6
    return A, b


def _velocity_pin(F: int, mask, dtype):
    """Unit-diagonal entries pinning the velocity of frames that touch no
    valid interval (keeps the masked system well posed)."""
    mask = mask.bool()
    zero = torch.zeros(1, dtype=torch.bool, device=mask.device)
    act = torch.cat([mask, zero]) | torch.cat([zero, mask])  # [F]
    pin = (~torch.repeat_interleave(act, 3)).to(dtype)
    return torch.cat([pin, torch.zeros(4, dtype=dtype, device=mask.device)])


def linear_alignment(R_wb, p_cam, tic, pres: Preintegration, g_norm: float = 9.81007,
                     mask=None) -> AlignResult:
    """LinearAlignment (:125-197): velocities, gravity and scale; accepted
    when |g| is near g_norm and s > 0."""
    F = R_wb.shape[0]
    A, b = _build_lin_system(R_wb, p_cam, tic, pres, mask)
    pin = None if mask is None else _velocity_pin(F, mask, A.dtype)
    x, s_rel = _ls_qr(A, b, pin)
    s = x[-1] / 100.0
    g = x[3 * F:3 * F + 3]
    ok = (torch.abs(torch.linalg.vector_norm(g) - g_norm) < 1.0) & (s > 0)
    return AlignResult(v_body=x[:3 * F].reshape(F, 3), g_c0=g, scale=s, ok=ok, s_rel_sigma=s_rel)


def _tangent_basis(g):
    a = g / torch.linalg.vector_norm(g)
    eye = torch.eye(3, dtype=g.dtype, device=g.device)
    tmp = torch.where(torch.abs(a[2]) > 0.999, eye[0], eye[2])
    b1 = tmp - a * torch.dot(a, tmp)
    b1 = b1 / torch.linalg.vector_norm(b1)
    return torch.stack([b1, torch.linalg.cross(a, b1)], dim=1)  # [3,2]


def refine_gravity(R_wb, p_cam, tic, pres: Preintegration, g0, g_norm: float = 9.81007,
                   iters: int = 4, mask=None) -> AlignResult:
    """RefineGravity (:55-123): g = ĝ·g_norm + B(ĝ)·dg on the 2-dim tangent
    of the gravity sphere; `iters` fixed re-linearizations."""
    F = R_wb.shape[0]
    dtype = p_cam.dtype
    A, b = _build_lin_system(R_wb, p_cam, tic, pres, mask)
    pin = None
    if mask is not None:
        pin = torch.cat([_velocity_pin(F, mask, dtype)[:3 * F],
                         torch.zeros(3, dtype=dtype, device=A.device)])
    cols_v, cols_g, cols_s = A[:, :3 * F], A[:, 3 * F:3 * F + 3], A[:, 3 * F + 3:]
    g = g0
    for _ in range(iters):
        Bg = _tangent_basis(g)
        g_hat = g / torch.linalg.vector_norm(g) * g_norm
        x, s_rel = _ls_qr(torch.cat([cols_v, cols_g @ Bg, cols_s], dim=1), b - cols_g @ g_hat,
                          pin)
        g = g_hat + Bg @ x[3 * F:3 * F + 2]
    s = x[-1] / 100.0
    return AlignResult(v_body=x[:3 * F].reshape(F, 3), g_c0=g, scale=s, ok=s > 0,
                       s_rel_sigma=s_rel)


def visual_imu_alignment(q_wb, p_cam, tic, pres: Preintegration, g_norm: float = 9.81007,
                         mask=None) -> AlignResult:
    """VisualIMUAlignment without its repropagation step (:199-207): the
    caller repropagates at the solved gyro bias first; this chains the
    linear and the refinement solves."""
    R_wb = lie.q2R(q_wb)
    lin = linear_alignment(R_wb, p_cam, tic, pres, g_norm, mask=mask)
    ref = refine_gravity(R_wb, p_cam, tic, pres, lin.g_c0, g_norm, mask=mask)
    return AlignResult(v_body=ref.v_body, g_c0=ref.g_c0, scale=ref.scale, ok=lin.ok & ref.ok,
                       s_rel_sigma=ref.s_rel_sigma)
