"""Intrinsic camera calibration: Zhang init + batched GN refinement.

PyTorch counterpart of `vins_tpu/calib/intrinsics.py` (the reference's
offline calibration, camera_model/src/calib/CameraCalibration.cc +
intrinsic_calib.cc: per-model initial intrinsics from chessboard
homographies, then Ceres autodiff refinement via CostFunctionFactory.cc).
Batched DLT homographies and Zhang's closed-form absolute-conic solve give
the initial K; then a damped Gauss-Newton over [intrinsics | per-view
extrinsics] with all views and corners as fixed-shape masked tensors, its
Jacobian by `torch.func.jacfwd`, every step on the device (the accept /
reject of each step is a `torch.where`, so the loop never reads back).

Models as in CameraFactory.cc: PINHOLE (radtan), KANNALA_BRANDT
(equidistant θ-polynomial), MEI (unified sphere + radtan) and SCARAMUZZA
(OCAM inverse polynomial).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie
from ..core.linalg import det3x3, inv3x3, spd_solve


# --------------------------------------------------------------------- DLT

def homography_dlt(obj: torch.Tensor, img: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plane→image homography by masked DLT (obj [..., N, 2] board coords,
    img [..., N, 2] pixels, valid [..., N]), Hartley-normalized; returns H
    [..., 3, 3] with H[2, 2] = 1.  The null vector of AᵀA is `eigh`'s first
    eigenvector; its sign and scale go with the normalization."""
    w = valid.to(obj.dtype)
    nw = torch.clamp(torch.sum(w, -1), min=1.0)

    def normalizer(x):
        mu = torch.sum(x * w[..., None], -2) / nw[..., None]
        d = torch.sqrt(torch.sum((x - mu[..., None, :]) ** 2, -1)) * w
        s = 2.0 ** 0.5 / torch.clamp(torch.sum(d, -1) / nw, min=1e-12)
        zero = torch.zeros_like(s)
        T = torch.stack([
            torch.stack([s, zero, -s * mu[..., 0]], -1),
            torch.stack([zero, s, -s * mu[..., 1]], -1),
            torch.stack([zero, zero, torch.ones_like(s)], -1),
        ], -2)
        return (x - mu[..., None, :]) * s[..., None, None], T

    o, To = normalizer(obj)
    i, Ti = normalizer(img)

    z = torch.zeros_like(o[..., 0])
    one = torch.ones_like(z)
    r1 = torch.stack([o[..., 0], o[..., 1], one, z, z, z,
                      -i[..., 0] * o[..., 0], -i[..., 0] * o[..., 1], -i[..., 0]], -1)
    r2 = torch.stack([z, z, z, o[..., 0], o[..., 1], one,
                      -i[..., 1] * o[..., 0], -i[..., 1] * o[..., 1], -i[..., 1]], -1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], -2)  # [..., 2N, 9]
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    Hn = V[..., :, 0].unflatten(-1, (3, 3))
    H = inv3x3(Ti) @ (Hn @ To)
    return H / H[..., 2:3, 2:3]


def zhang_intrinsics(Hs: torch.Tensor, view_valid: torch.Tensor) -> torch.Tensor:
    """Closed-form K from ≥ 3 homographies (Zhang 2000): constraints on the
    image of the absolute conic B = K⁻ᵀK⁻¹.  Returns [fx, fy, cx, cy]
    (zero-skew solve).  Hs: [V, 3, 3]."""
    dt = Hs.dtype

    def v_ij(a, b):
        H = Hs
        return torch.stack([
            H[:, 0, a] * H[:, 0, b],
            H[:, 0, a] * H[:, 1, b] + H[:, 1, a] * H[:, 0, b],
            H[:, 1, a] * H[:, 1, b],
            H[:, 2, a] * H[:, 0, b] + H[:, 0, a] * H[:, 2, b],
            H[:, 2, a] * H[:, 1, b] + H[:, 1, a] * H[:, 2, b],
            H[:, 2, a] * H[:, 2, b],
        ], -1)

    A = torch.stack([v_ij(0, 1), v_ij(0, 0) - v_ij(1, 1)], 1)  # [V, 2, 6]
    A = (A * view_valid[:, None, None].to(dt)).reshape(-1, 6)
    _, V = torch.linalg.eigh(A.T @ A)
    B11, B12, B22, B13, B23, B33 = V[:, 0].unbind(-1)
    cy = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 * B12)
    lam = B33 - (B13 * B13 + cy * (B12 * B13 - B11 * B23)) / B11
    fx = torch.sqrt(torch.abs(lam / B11))
    fy = torch.sqrt(torch.abs(lam * B11 / (B11 * B22 - B12 * B12)))
    cx = -B13 * fx * fx / lam
    return torch.stack([fx, fy, cx, cy])


def extrinsics_from_h(H: torch.Tensor, K: torch.Tensor):
    """Board pose(s) from homographies H [..., 3, 3] = K [r1 r2 t], the
    rotation projected onto SO(3) by an SVD.  Returns (R [..., 3, 3],
    t [..., 3])."""
    dt, dev = H.dtype, H.device
    zero, one = torch.zeros((), dtype=dt, device=dev), torch.ones((), dtype=dt, device=dev)
    Km = torch.stack([torch.stack([K[0], zero, K[2]]), torch.stack([zero, K[1], K[3]]),
                      torch.stack([zero, zero, one])])
    M = inv3x3(Km) @ H
    s = 1.0 / torch.clamp(torch.linalg.vector_norm(M[..., :, 0], dim=-1), min=1e-12)
    s = s * torch.sign(M[..., 2, 2])  # cheirality: the board in front
    r1 = M[..., :, 0] * s[..., None]
    r2 = M[..., :, 1] * s[..., None]
    t = M[..., :, 2] * s[..., None]
    r3 = torch.linalg.cross(r1, r2)
    R = torch.stack([r1, r2, r3], -1)
    U, _, Vt = torch.linalg.svd(R)
    det = det3x3(U @ Vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    return U @ torch.diag_embed(d) @ Vt, t


# ----------------------------------------------------------------- models

def project_pinhole(params: torch.Tensor, Pc: torch.Tensor) -> torch.Tensor:
    """[fx,fy,cx,cy,k1,k2,p1,p2] radtan projection (PinholeCamera.cc
    spaceToPlane + distortion, :519-542)."""
    fx, fy, cx, cy, k1, k2, p1, p2 = params.unbind(-1)
    xy = Pc[..., :2] / Pc[..., 2:3]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    rad = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([fx * xd + cx, fy * yd + cy], -1)


def project_kb(params: torch.Tensor, Pc: torch.Tensor) -> torch.Tensor:
    """[mu,mv,u0,v0,k2,k3,k4,k5] Kannala-Brandt θ-polynomial projection
    (EquidistantCamera.cc spaceToPlane)."""
    mu, mv, u0, v0, k2, k3, k4, k5 = params.unbind(-1)
    r_xy = torch.linalg.vector_norm(Pc[..., :2], dim=-1)
    theta = torch.atan2(r_xy, Pc[..., 2])
    t2 = theta * theta
    d = theta * (1.0 + t2 * (k2 + t2 * (k3 + t2 * (k4 + t2 * k5))))
    scale = d / torch.clamp(r_xy, min=1e-12)
    return torch.stack([mu * Pc[..., 0] * scale + u0, mv * Pc[..., 1] * scale + v0], -1)


def project_mei(params: torch.Tensor, Pc: torch.Tensor) -> torch.Tensor:
    """[xi,gamma1,gamma2,u0,v0,k1,k2,p1,p2] unified-sphere projection
    (CataCamera.cc spaceToPlane): z' = z + ξ·|P|, radtan, then gamma."""
    xi, fx, fy, cx, cy, k1, k2, p1, p2 = params.unbind(-1)
    z = Pc[..., 2] + xi * torch.linalg.vector_norm(Pc, dim=-1)
    x = Pc[..., 0] / z
    y = Pc[..., 1] / z
    r2 = x * x + y * y
    rad = k1 * r2 + k2 * r2 * r2
    dx = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    dy = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([fx * (x + dx) + cx, fy * (y + dy) + cy], -1)


def project_scaramuzza(params: torch.Tensor, Pc: torch.Tensor) -> torch.Tensor:
    """[C,D,E,cx,cy,i0..i4] OCAM world→image (ScaramuzzaCamera.cc:632-653):
    ρ = inv_poly(θ) with θ = atan2(−z, ‖xy‖), then the affine warp."""
    C, D, E, cx, cy = params[..., :5].unbind(-1)
    inv_poly = params[..., 5:]
    norm = torch.sqrt(Pc[..., 0] ** 2 + Pc[..., 1] ** 2)
    theta = torch.atan2(-Pc[..., 2], norm)
    rho = torch.zeros_like(theta)
    for k in range(inv_poly.shape[-1] - 1, -1, -1):  # Horner, as jnp.polyval
        rho = rho * theta + inv_poly[..., k]
    inv_norm = 1.0 / torch.clamp(norm, min=1e-12)
    xn = Pc[..., 0] * inv_norm * rho
    yn = Pc[..., 1] * inv_norm * rho
    return torch.stack([xn * C + yn * D + cx, xn * E + yn + cy], -1)


SCARA_POLY_DEG = 5  # inverse-polynomial coefficients fitted in calibration
_PROJECT = {"PINHOLE": project_pinhole, "KANNALA_BRANDT": project_kb,
            "MEI": project_mei, "SCARAMUZZA": project_scaramuzza}
_N_INTR = {"PINHOLE": 8, "KANNALA_BRANDT": 8, "MEI": 9,
           "SCARAMUZZA": 5 + SCARA_POLY_DEG}


class CalibResult(NamedTuple):
    intrinsics: torch.Tensor  # [n_intr(model)]
    rvecs: torch.Tensor  # [V,4] board→camera quaternions
    tvecs: torch.Tensor  # [V,3]
    rms: torch.Tensor  # [] reprojection RMS (pixels)
    per_view_rms: torch.Tensor  # [V]


def _board_in_camera(q: torch.Tensor, t: torch.Tensor, obj: torch.Tensor) -> torch.Tensor:
    """Board-plane points obj [V, N, 2] → camera frame through (q [V, 4],
    t [V, 3])."""
    Pb = torch.cat([obj, torch.zeros_like(obj[..., :1])], -1)
    return lie.qrotate(q[:, None, :], Pb) + t[:, None, :]


def refine_calibration(intr0: torch.Tensor, q0: torch.Tensor, t0: torch.Tensor,
                       obj: torch.Tensor, img: torch.Tensor, valid: torch.Tensor,
                       view_valid: torch.Tensor, model: str = "PINHOLE",
                       iters: int = 15) -> CalibResult:
    """Joint GN over intrinsics + per-view extrinsics (the reference's Ceres
    problem in CameraCalibration.cc optimize()), LM-damped, `iters` steps:
    each step solves (H + μ diag H + 1e-9 I) dx = −g, keeps x + dx only if
    the cost falls, and multiplies μ by 0.3 on a kept step, by 10 on a
    refused one (μ₀ = 1e-3).  Shapes: intr0 [n_intr], q0 [V, 4] (cam←board),
    t0 [V, 3], obj / img [V, N, 2], valid [V, N], view_valid [V]."""
    proj = _PROJECT[model]
    n_intr = _N_INTR[model]
    V = obj.shape[0]
    dt, dev = obj.dtype, obj.device
    w = (valid & view_valid[:, None]).to(dt)
    nobs = torch.clamp(torch.sum(w), min=1.0)
    dim = n_intr + 6 * V
    eye = torch.eye(dim, dtype=dt, device=dev)

    def residuals(x):
        intr = x[:n_intr]
        ext = x[n_intr:].reshape(V, 6)
        qq = lie.qmul(q0, lie.deltaQ(ext[:, :3]))
        pred = proj(intr, _board_in_camera(qq, t0 + ext[:, 3:], obj))
        return ((pred - img) * w[..., None]).reshape(-1)

    jac = torch.func.jacfwd(residuals)
    x = torch.cat([intr0, torch.zeros(V * 6, dtype=dt, device=dev)])
    mu = torch.full((), 1e-3, dtype=dt, device=dev)
    cost = torch.sum(residuals(x) ** 2)
    for _ in range(iters):
        r = residuals(x)
        J = jac(x)
        H = J.T @ J
        g = J.T @ r
        Hd = H + mu * torch.diag(torch.diagonal(H)) + 1e-9 * eye
        x_new = x - spd_solve(Hd, g)
        c_new = torch.sum(residuals(x_new) ** 2)
        ok = c_new < cost
        x = torch.where(ok, x_new, x)
        mu = torch.where(ok, mu * 0.3, mu * 10.0)
        cost = torch.minimum(c_new, cost)

    intr = x[:n_intr]
    ext = x[n_intr:].reshape(V, 6)
    qq = lie.qmul(q0, lie.deltaQ(ext[:, :3]))
    t = t0 + ext[:, 3:]
    errs = torch.sum((proj(intr, _board_in_camera(qq, t, obj)) - img) ** 2, -1) * w  # [V, N]
    rms = torch.sqrt(torch.sum(errs) / nobs)
    pv = torch.sqrt(torch.sum(errs, 1) / torch.clamp(torch.sum(w, 1), min=1.0))
    return CalibResult(intrinsics=intr, rvecs=lie.qnormalize(qq), tvecs=t, rms=rms,
                       per_view_rms=pv)


def calibrate(obj: torch.Tensor, img: torch.Tensor, valid: torch.Tensor,
              model: str = "PINHOLE", iters: int = 15) -> CalibResult:
    """Full pipeline: homographies → Zhang K → per-view extrinsics → GN, on
    the inputs' device.

    obj / img: [V, N, 2] board coords / pixels, valid: [V, N] (masked fixed
    shapes).  KANNALA_BRANDT starts from the pinhole Zhang solve with zero
    distortion polynomial (EquidistantCamera::estimateIntrinsics' role); MEI
    from ξ = 1 and γ = 2·f; SCARAMUZZA from a linear least-squares fit of
    the inverse polynomial with the Zhang extrinsics fixed."""
    dt, dev = obj.dtype, obj.device
    view_valid = valid.any(dim=1)
    Hs = homography_dlt(obj, img, valid)
    K = zhang_intrinsics(Hs, view_valid)
    Rs, ts = extrinsics_from_h(Hs, K)
    qs = lie.R2q(Rs)
    if model == "MEI":
        # ξ₀ = 1: the effective pinhole focal at the center is γ/(1+ξ), so
        # seed γ = 2·f_zhang (CataCamera estimateIntrinsics plays this role)
        intr0 = torch.cat([torch.ones(1, dtype=dt, device=dev), 2.0 * K[:2], K[2:],
                           torch.zeros(4, dtype=dt, device=dev)])
    elif model == "SCARAMUZZA":
        # linear inverse-polynomial seed (the OCAM-toolbox recipe): with the
        # Zhang extrinsics fixed, ρ(θ) is linear in the coefficients
        Pc = _board_in_camera(qs, ts, obj)
        th = torch.atan2(-Pc[..., 2], torch.sqrt(Pc[..., 0] ** 2 + Pc[..., 1] ** 2)).reshape(-1)
        rho = torch.linalg.vector_norm(img - K[2:], dim=-1).reshape(-1)
        wv = (valid & view_valid[:, None]).reshape(-1).to(dt)
        Adm = th[:, None] ** torch.arange(SCARA_POLY_DEG, dtype=dt, device=dev)[None]
        Adm = Adm * wv[:, None]
        Hp = Adm.T @ Adm + 1e-9 * torch.eye(SCARA_POLY_DEG, dtype=dt, device=dev)
        poly0 = spd_solve(Hp, Adm.T @ (rho * wv))
        intr0 = torch.cat([torch.tensor([1.0, 0.0, 0.0], dtype=dt, device=dev), K[2:], poly0])
    else:
        intr0 = torch.cat([K, torch.zeros(4, dtype=dt, device=dev)])
    return refine_calibration(intr0, qs, ts, obj, img, valid, view_valid, model=model,
                              iters=iters)
