"""IMU pre-integration.

PyTorch counterpart of `vins_tpu/imu/preintegration.py`, the reference's
`IntegrationBase` (vins_estimator/src/factor/integration_base.h:54-186):
midpoint integration of Δp/Δq/Δv between two camera frames, with the
discrete propagation of the 15×15 bias/state Jacobian and covariance, and
the IMU factor residual (imu_factor.h:19-77).

State ordering [δp, δθ, δv, δba, δbg]; noise ordering
[na0, nw0, na1, nw1, nba_rw, nbg_rw] (18-dim).  Like the reference, Q holds
the continuous densities squared and V carries plain dt factors.

Every function takes leading batch dims: one window's F-1 intervals
integrate in one call.  Intervals are padded to N samples (`mask[k] = 0`
for padding); a masked step is an exact identity.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie
from ..core.linalg import cholesky_nan


class ImuNoise(NamedTuple):
    """Continuous-time noise densities (euroc_config.yaml acc_n/gyr_n/acc_w/gyr_w)."""

    acc_n: float = 0.08
    gyr_n: float = 0.004
    acc_w: float = 0.00004
    gyr_w: float = 2.0e-6

    def Q18(self, dtype=torch.float64, device="cpu") -> torch.Tensor:
        d = torch.empty(18, dtype=dtype, device=device)
        for k, v in enumerate((self.acc_n, self.gyr_n, self.acc_n, self.gyr_n,
                               self.acc_w, self.gyr_w)):
            d[3 * k:3 * k + 3] = v * v
        return torch.diag(d)


class Preintegration(NamedTuple):
    """Result of integrating one IMU interval (or a batch of them) at
    linearization biases."""

    dp: torch.Tensor  # [..., 3]
    dq: torch.Tensor  # [..., 4]
    dv: torch.Tensor  # [..., 3]
    J: torch.Tensor  # [..., 15, 15] d(delta)/d(state0 perturbation)
    P: torch.Tensor  # [..., 15, 15] covariance
    sqrt_info: torch.Tensor  # [..., 15, 15] whitener, AᵀA = P⁻¹
    dt_sum: torch.Tensor  # [...]
    ba_lin: torch.Tensor  # [..., 3] linearization accel bias
    bg_lin: torch.Tensor  # [..., 3] linearization gyro bias


def _blockrows(rows) -> torch.Tensor:
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def _transition(R_pre, R_post, a0, a1, w, d1, d2, eye):
    """Discrete transition F [..., 15, 15] and noise input V [..., 15, 18] of
    midpoint steps (integration_base.h:54-128); d1, d2 are dt and dt² shaped
    [..., 1, 1]."""
    Z = torch.zeros_like(R_pre)
    eyeN = eye.expand_as(R_pre)
    S0, S1 = lie.skew(a0), lie.skew(a1)
    Rw = eyeN - lie.skew(w) * d1  # ≈ exp(-w dt)
    R1S1 = R_post @ S1
    dA_dth = -0.5 * (R_pre @ S0 + R1S1 @ Rw)
    dA_dba = -0.5 * (R_pre + R_post)
    dA_dbg = 0.5 * R1S1 * d1
    F = _blockrows([
        [eyeN, dA_dth * 0.5 * d2, eyeN * d1, dA_dba * 0.5 * d2, dA_dbg * 0.5 * d2],
        [Z, Rw, Z, Z, -eyeN * d1],
        [Z, dA_dth * d1, eyeN, dA_dba * d1, dA_dbg * d1],
        [Z, Z, Z, eyeN, Z],
        [Z, Z, Z, Z, eyeN],
    ])
    h = -0.25 * R1S1 * d1  # d(a_mid)/d(nw*) (via δθ_{k+1})
    V = _blockrows([
        [0.25 * R_pre * d2, h * 0.5 * d2, 0.25 * R_post * d2, h * 0.5 * d2, Z, Z],
        [Z, 0.5 * eyeN * d1, Z, 0.5 * eyeN * d1, Z, Z],
        [0.5 * R_pre * d1, h * d1, 0.5 * R_post * d1, h * d1, Z, Z],
        [Z, Z, Z, Z, eyeN * d1, Z],
        [Z, Z, Z, Z, Z, eyeN * d1],
    ])
    return F, V


def _identity_quat(shape, dtype, device) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 0:1] = 1.0
    return q


def preintegrate_sequential(dt, acc, gyr, ba, bg, noise: ImuNoise = ImuNoise(),
                            mask=None) -> Preintegration:
    """The literal serial recurrence of integration_base.h:54-128, one
    midpoint step after another: the exact reference for `preintegrate`.
    dt [..., N], acc/gyr [..., N+1, 3], ba/bg [..., 3], mask [..., N]."""
    dtype, dev = acc.dtype, acc.device
    n = dt.shape[-1]
    mask = torch.ones_like(dt) if mask is None else mask.to(dtype)
    Q = noise.Q18(dtype, dev)
    eye = torch.eye(3, dtype=dtype, device=dev)
    batch = dt.shape[:-1]
    dp = torch.zeros(batch + (3,), dtype=dtype, device=dev)
    dv = torch.zeros_like(dp)
    dq = _identity_quat(batch, dtype, dev)
    J = torch.eye(15, dtype=dtype, device=dev).expand(batch + (15, 15))
    P = torch.zeros(batch + (15, 15), dtype=dtype, device=dev)
    for k in range(n):
        d = dt[..., k, None]
        w = 0.5 * (gyr[..., k, :] + gyr[..., k + 1, :]) - bg
        dq_new = lie.qnormalize(lie.qmul(dq, lie.deltaQ(w * d)))
        R0, R1 = lie.q2R(dq), lie.q2R(dq_new)
        a0, a1 = acc[..., k, :] - ba, acc[..., k + 1, :] - ba
        a_mid = 0.5 * ((R0 @ a0[..., None])[..., 0] + (R1 @ a1[..., None])[..., 0])
        dp_new = dp + dv * d + 0.5 * a_mid * d * d
        dv_new = dv + a_mid * d
        F, V = _transition(R0, R1, a0, a1, w, d[..., None], (d * d)[..., None], eye)
        J_new = F @ J
        P_new = F @ P @ F.transpose(-1, -2) + V @ Q @ V.transpose(-1, -2)
        keep = mask[..., k] > 0
        dp = torch.where(keep[..., None], dp_new, dp)
        dq = torch.where(keep[..., None], dq_new, dq)
        dv = torch.where(keep[..., None], dv_new, dv)
        J = torch.where(keep[..., None, None], J_new, J)
        P = torch.where(keep[..., None, None], P_new, P)
    dt_sum = torch.sum(dt * mask, dim=-1)
    return Preintegration(dp, dq, dv, J, P, _sqrt_info(P), dt_sum, ba, bg)


def prefix_scan(combine, xs, dim: int):
    """Inclusive scan of an associative `combine(earlier, later)` along
    `dim` of every tensor in the tuple `xs`, by recursive doubling: ⌈log₂N⌉
    rounds, each one batched `combine` over all positions."""
    n = xs[0].shape[dim]
    d = 1
    while d < n:
        early = tuple(x.narrow(dim, 0, n - d) for x in xs)
        late = tuple(x.narrow(dim, d, n - d) for x in xs)
        new = combine(early, late)
        xs = tuple(torch.cat([x.narrow(dim, 0, d), y], dim=dim) for x, y in zip(xs, new))
        d *= 2
    return xs


def preintegrate(dt, acc, gyr, ba, bg, noise: ImuNoise = ImuNoise(),
                 mask=None) -> Preintegration:
    """Integrate intervals at biases (ba, bg); re-run with new biases to
    'repropagate' (integration_base.h:38-52).  dt [..., N] gaps between
    samples, acc/gyr [..., N+1, 3] boundary samples, ba/bg [..., 3],
    mask [..., N] (1 = real step).

    The N-step recurrence is decomposed into associative pieces, each a
    `prefix_scan` of log₂N rounds over the N axis (as the reference
    package's associative scans): the rotation prefixes R_k = Πδq_{<k}; the
    midpoint accelerations, and Δv/Δp as cumulative sums; and (J, P) as the
    monoid (A₁,P₁)∘(A₂,P₂) = (A₂A₁, A₂P₁A₂ᵀ + P₂) over the per-step (F, VQVᵀ).
    Masked steps use dt = 0, which makes every piece an exact identity."""
    dtype, dev = acc.dtype, acc.device
    mask = torch.ones_like(dt) if mask is None else mask.to(dtype)
    Q = noise.Q18(dtype, dev)
    eye = torch.eye(3, dtype=dtype, device=dev)

    dte = dt * mask                                         # [..., N]
    ba_, bg_ = ba[..., None, :], bg[..., None, :]
    a0 = acc[..., :-1, :] - ba_                             # [..., N, 3]
    a1 = acc[..., 1:, :] - ba_
    w = 0.5 * (gyr[..., :-1, :] + gyr[..., 1:, :]) - bg_

    dq_inc = lie.deltaQ(w * dte[..., None])                 # [..., N, 4]
    (dq_incl,) = prefix_scan(lambda a, b: (lie.qmul(a[0], b[0]),), (dq_inc,), -2)
    dq_incl = dq_incl / torch.linalg.vector_norm(dq_incl, dim=-1, keepdim=True)
    q_pre = torch.cat([_identity_quat(dq_incl.shape[:-2] + (1,), dtype, dev),
                       dq_incl[..., :-1, :]], dim=-2)
    q_post = dq_incl
    R_pre, R_post = lie.q2R(q_pre), lie.q2R(q_post)        # [..., N, 3, 3]

    a_mid = 0.5 * ((R_pre @ a0[..., None])[..., 0] + (R_post @ a1[..., None])[..., 0])
    dv_steps = a_mid * dte[..., None]
    dv_incl = torch.cumsum(dv_steps, dim=-2)
    dv_pre = dv_incl - dv_steps  # exclusive prefix: dv at step start
    dp_incl = torch.cumsum(dv_pre * dte[..., None] + 0.5 * a_mid * dte[..., None] ** 2, dim=-2)
    dp, dq, dv = dp_incl[..., -1, :], q_post[..., -1, :], dv_incl[..., -1, :]

    d1 = dte[..., None, None]
    F, V = _transition(R_pre, R_post, a0, a1, w, d1, d1 * d1, eye)   # [..., N, 15, *]
    VQVt = V @ Q @ V.transpose(-1, -2)

    def compose(a, b):
        A1, P1 = a
        A2, P2 = b
        return A2 @ A1, A2 @ P1 @ A2.transpose(-1, -2) + P2

    A_scan, P_scan = prefix_scan(compose, (F, VQVt), -3)
    J, P = A_scan[..., -1, :, :], P_scan[..., -1, :, :]
    dt_sum = torch.sum(dte, dim=-1)
    return Preintegration(dp, dq, dv, J, P, _sqrt_info(P), dt_sum, ba, bg)


def _sqrt_info(P: torch.Tensor) -> torch.Tensor:
    """Whitener A = L⁻¹ with P = L Lᵀ (A P Aᵀ = I), on the Jacobi-scaled P
    (P = D C D with unit-diagonal C, regularized relative to each block's
    own scale).  The reference takes LLT(P⁻¹).L().T (imu_factor.h:64-66);
    only AᵀA = P⁻¹ enters the normal equations."""
    dtype = P.dtype
    eps = 1e-12 if dtype == torch.float64 else 1e-6
    floor = 1e-300 if dtype == torch.float64 else 1e-30
    eye = torch.eye(15, dtype=dtype, device=P.device)
    d = torch.sqrt(torch.clamp(torch.diagonal(P, dim1=-2, dim2=-1), min=floor))
    C = P / d[..., :, None] / d[..., None, :]
    L = cholesky_nan(C + eps * eye)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return Linv / d[..., None, :]


def bias_corrected_deltas(pre: Preintegration, ba_i, bg_i):
    """First-order bias correction of the integrated deltas
    (integration_base.h:173-178)."""
    dba = (ba_i - pre.ba_lin)[..., None]
    dbg = (bg_i - pre.bg_lin)[..., None]
    J = pre.J
    dp = pre.dp + (J[..., 0:3, 9:12] @ dba + J[..., 0:3, 12:15] @ dbg)[..., 0]
    dv = pre.dv + (J[..., 6:9, 9:12] @ dba + J[..., 6:9, 12:15] @ dbg)[..., 0]
    dq = lie.qmul(pre.dq, lie.deltaQ((J[..., 3:6, 12:15] @ dbg)[..., 0]))
    return dp, lie.qnormalize(dq), dv


def imu_residual(pre: Preintegration, p_i, q_i, v_i, ba_i, bg_i,
                 p_j, q_j, v_j, ba_j, bg_j, gravity, whiten: bool = True):
    """15-dim IMU factor residual (imu_factor.h:19-77 / integration_base.h:
    160-186): [r_p, r_θ, r_v, r_ba, r_bg], whitened by sqrt_info unless
    `whiten` is False.  gravity = [0, 0, +g] (world z up)."""
    dt = pre.dt_sum[..., None]
    dp, dq, dv = bias_corrected_deltas(pre, ba_i, bg_i)
    qi_inv = lie.qconj(q_i)
    Ri_T = lie.q2R(qi_inv)
    r_p = (Ri_T @ (0.5 * gravity * dt * dt + p_j - p_i - v_i * dt)[..., None])[..., 0] - dp
    q_err = lie.qmul(lie.qconj(dq), lie.qmul(qi_inv, q_j))
    r_th = 2.0 * q_err[..., 1:4]
    r_v = (Ri_T @ (gravity * dt + v_j - v_i)[..., None])[..., 0] - dv
    r = torch.cat([r_p, r_th, r_v, ba_j - ba_i, bg_j - bg_i], dim=-1)
    if whiten:
        r = (pre.sqrt_info @ r[..., None])[..., 0]
    return r
