"""Batched factor residuals + local Jacobians for the window solver.

PyTorch counterpart of `vins_tpu/solver/factors.py`: the reference's Ceres
cost functions as batched functions over the dense [L, F] factor grid
with a validity mask —
  * projection (+ time-offset / rolling-shutter) factor
    (projection_factor.cpp:21-116, projection_td_factor.cpp:18-52),
  * IMU factor (imu_factor.h:19-77; residual math in imu/preintegration.py),
  * relocalization projection factor (estimator.cpp:769-801).

The Jacobians over the local (tangent) perturbation are analytic, as the
reference's factors hand-derive them (projection_td_factor.cpp:77-170,
imu_factor.h:79-160), here written out exactly — with the normalized δq of
`pose_boxplus` and of the bias-corrected Δq — so they equal what the JAX
package's `jax.jacfwd` computes.  Every function broadcasts over leading
dims: one call evaluates all factors of the window with plain tensor ops.
(`torch.func.jacfwd` under `vmap`, and forward-mode dual tensors, compute
the same numbers, but in this PyTorch every elementwise op on a tangent
runs a Python decomposition, 0.25-2 ms each: ~2 s per window solve.)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie
from ..imu.preintegration import Preintegration, bias_corrected_deltas, imu_residual
from .problem import FeatureObs, Layout, WindowState

# local-perturbation dims
PROJ_DX = 20  # [pose_i 6, pose_j 6, ext 6, td 1, inv_depth 1]
IMU_DX = 30  # [pose_i 6, sb_i 9, pose_j 6, sb_j 9]


def _safe_inv(x, eps=1e-4):
    """Sign-preserving reciprocal, bounded away from the λ=0 pole, and its
    derivative (0 where clamped, as jnp.maximum's)."""
    s = torch.where(x >= 0, torch.ones_like(x), -torch.ones_like(x))
    m = torch.clamp(torch.abs(x), min=eps)
    return s / m, torch.where(torch.abs(x) > eps, -1.0 / (m * m), torch.zeros_like(x))


def safe_z(z, eps=1e-6):
    """z pushed away from 0 to ±eps, keeping its sign."""
    return torch.where(torch.abs(z) < eps,
                       torch.where(z >= 0, torch.full_like(z, eps), torch.full_like(z, -eps)), z)


def project(P, eps=1e-6):
    """(P[:2]/z, ∂(P[:2]/z)/∂P [..., 2, 3]) for camera points P [..., 3],
    with z = safe_z(P[2]) (whose derivative is 0 where it clamps)."""
    z = P[..., 2:3]
    zs = safe_z(z, eps)
    uv = P[..., :2] / zs
    dz = torch.where(torch.abs(z) < eps, torch.zeros_like(z), -1.0 / zs) * uv  # [..., 2]
    inv = 1.0 / zs
    zero = torch.zeros_like(inv)
    top = torch.cat([inv, zero], dim=-1)
    bot = torch.cat([zero, inv], dim=-1)
    return uv, torch.cat([torch.stack([top, bot], dim=-2), dz[..., None]], dim=-1)


def _T(R):
    return R.transpose(-1, -2)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _proj_chain(p_i, q_i, p_j, q_j, tic, qic, lam, td, pt_i, vel_i, toff_i,
                pt_j, vel_j, toff_j, jac: bool = True):
    """Projection factor residuals (un-whitened, normalized plane) and their
    Jacobians [..., 2, 20] over the local perturbation [dp_i, dθ_i, dp_j,
    dθ_j, dtic, dθic, dtd, dλ] (projection_td_factor.cpp:55-170): anchor-
    frame point at inverse depth λ → camera_i → body_i → world → body_j →
    camera_j, against the time-shifted observation in frame j."""
    R_i, R_j, R_ic = lie.q2R(q_i), lie.q2R(q_j), lie.q2R(qic)
    pt_i_td = pt_i - (td - toff_i)[..., None] * vel_i
    pt_j_td = pt_j - (td - toff_j)[..., None] * vel_j
    s, ds = _safe_inv(lam)
    h = torch.cat([pt_i_td, torch.ones_like(pt_i_td[..., :1])], dim=-1)
    P_ci = h * s[..., None]
    P_bi = _mv(R_ic, P_ci) + tic
    P_w = _mv(R_i, P_bi) + p_i
    P_bj = _mv(_T(R_j), P_w - p_j)
    P_cj = _mv(_T(R_ic), P_bj - tic)
    uv, dproj = project(P_cj)
    r = uv - pt_j_td
    if not jac:
        return r
    A = _T(R_ic) @ _T(R_j)                # ∂P_cj/∂P_w
    B = A @ R_i                           # ∂P_cj/∂P_bi
    C = B @ R_ic                          # ∂P_cj/∂P_ci
    shape = torch.broadcast_shapes(C.shape, P_ci.shape[:-1] + (3, 3))
    A, B, C = A.expand(shape), B.expand(shape), C.expand(shape)
    RicT = _T(R_ic).expand(shape)
    d_td = torch.cat([-vel_i * s[..., None], torch.zeros_like(s[..., None])], dim=-1)
    cols = torch.cat([
        A, -B @ lie.skew(P_bi),                       # pose i
        -A, RicT @ lie.skew(P_bj),                    # pose j
        B - RicT, lie.skew(P_cj) - C @ lie.skew(P_ci),  # extrinsic
        _mv(C, d_td)[..., None], _mv(C, h * ds[..., None])[..., None],  # td, λ
    ], dim=-1)                                        # ∂P_cj/∂dx [..., 3, 20]
    J = dproj @ cols
    # the observation's own time shift: ∂(−pt_j_td)/∂td = +vel_j
    J = torch.cat([J[..., :18], J[..., 18:19] + vel_j.expand(J.shape[:-1])[..., None],
                   J[..., 19:]], dim=-1)
    return r, J


def anchor_gather(obs: FeatureObs):
    """Per-landmark anchor-frame observation (pt_i [L,2], vel_i, toff_i [L])."""
    a = obs.anchor
    pt_i = torch.take_along_dim(obs.pt, a[:, None, None], dim=1)[:, 0]
    vel_i = torch.take_along_dim(obs.vel, a[:, None, None], dim=1)[:, 0]
    toff_i = torch.take_along_dim(obs.toff, a[:, None], dim=1)[:, 0]
    return pt_i, vel_i, toff_i


def proj_valid(obs: FeatureObs) -> torch.Tensor:
    F = obs.valid.shape[1]
    frame_idx = torch.arange(F, device=obs.valid.device)[None, :]
    return obs.valid & obs.active[:, None] & (frame_idx != obs.anchor[:, None])


def _proj_args(state: WindowState, obs: FeatureObs):
    """Arguments of `_proj_chain` broadcasting to the [L, F] grid."""
    pt_i, vel_i, toff_i = anchor_gather(obs)
    a = obs.anchor
    return (state.p[a][:, None], state.q[a][:, None], state.p[None], state.q[None],
            state.tic, state.qic, obs.inv_depth[:, None], state.td,
            pt_i[:, None], vel_i[:, None], toff_i[:, None], obs.pt, obs.vel, obs.toff)


class ProjBlocks(NamedTuple):
    r: torch.Tensor  # [L, F, 2] whitened residuals
    J: torch.Tensor  # [L, F, 2, PROJ_DX] whitened local Jacobians
    valid: torch.Tensor  # [L, F] bool


def projection_blocks(state: WindowState, obs: FeatureObs, focal: float = 460.0) -> ProjBlocks:
    """All projection factors on the [L, F] grid; sqrt_info = focal/1.5 · I₂
    (estimator.cpp:17).  Factor (l, f) relates the anchor observation of
    landmark l to its observation in frame f; anchor frames and invalid
    observations are masked."""
    r, J = _proj_chain(*_proj_args(state, obs))
    valid = proj_valid(obs)
    m = valid[..., None].to(r.dtype) * (focal / 1.5)
    return ProjBlocks(r=r * m, J=J * m[..., None], valid=valid)


def projection_residuals(state: WindowState, obs: FeatureObs, focal: float = 460.0):
    """Residual-only projection evaluation for cost checks: (r [L, F, 2]
    whitened, valid [L, F])."""
    r = _proj_chain(*_proj_args(state, obs), jac=False)
    valid = proj_valid(obs)
    return r * (valid[..., None].to(r.dtype) * (focal / 1.5)), valid


class ImuBlocks(NamedTuple):
    r: torch.Tensor  # [F-1, 15] whitened residuals
    J: torch.Tensor  # [F-1, 15, IMU_DX] whitened local Jacobians
    valid: torch.Tensor  # [F-1] bool


def _imu_chain(pre: Preintegration, p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j, bg_j,
               gravity):
    """Whitened `imu_residual` [..., 15] and its whitened Jacobian
    [..., 15, 30] over [dp_i, dθ_i, dv_i, dba_i, dbg_i, dp_j, dθ_j, dv_j,
    dba_j, dbg_j] (imu_factor.h:79-160, exact in the rotation terms)."""
    dtype, dev = p_i.dtype, p_i.device
    dt = pre.dt_sum[..., None]
    J = pre.J
    Jpba, Jpbg = J[..., 0:3, 9:12], J[..., 0:3, 12:15]
    Jqbg = J[..., 3:6, 12:15]
    Jvba, Jvbg = J[..., 6:9, 9:12], J[..., 6:9, 12:15]
    dp_c, dc, dv_c = bias_corrected_deltas(pre, ba_i, bg_i)
    RiT = _T(lie.q2R(q_i))
    a_p = 0.5 * gravity * dt * dt + p_j - p_i - v_i * dt
    a_v = gravity * dt + v_j - v_i
    A = lie.qmul(lie.qconj(q_i), q_j)
    E = lie.qmul(lie.qconj(dc), A)
    # ∂δ/∂φ of δ = normalize([1, φ/2]) at φ = Jqbg·(bg_i − bg_lin)
    phi = _mv(Jqbg, bg_i - pre.bg_lin)
    u = torch.cat([torch.ones_like(phi[..., :1]), 0.5 * phi], dim=-1)
    n = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    delta = u / n
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    half = torch.cat([torch.zeros((1, 3), dtype=dtype, device=dev),
                      0.5 * torch.eye(3, dtype=dtype, device=dev)], dim=0)  # [4,3]
    D = (eye4 - delta[..., :, None] * delta[..., None, :]) / n[..., None] @ half
    conj = -eye4
    conj[:1, :1] = 1.0  # q ↦ q*
    dth_bg = 2.0 * (lie.Qright(A) @ conj @ lie.Qleft(pre.dq) @ D @ Jqbg)[..., 1:, :]
    dth_i = -(lie.Qleft(lie.qconj(dc)) @ lie.Qright(A))[..., 1:, 1:]
    dth_j = lie.Qleft(E)[..., 1:, 1:]

    shape = RiT.shape[:-2]
    Z = torch.zeros(shape + (3, 3), dtype=dtype, device=dev)
    I3 = torch.eye(3, dtype=dtype, device=dev).expand(shape + (3, 3))
    ex = lambda M: M.expand(shape + (3, 3))  # noqa: E731
    rows = [
        [-RiT, lie.skew(_mv(RiT, a_p)), -RiT * dt[..., None], -ex(Jpba), -ex(Jpbg),
         RiT, Z, Z, Z, Z],
        [Z, ex(dth_i), Z, Z, ex(dth_bg), Z, ex(dth_j), Z, Z, Z],
        [Z, lie.skew(_mv(RiT, a_v)), -RiT, -ex(Jvba), -ex(Jvbg), Z, Z, RiT, Z, Z],
        [Z, Z, Z, -I3, Z, Z, Z, Z, I3, Z],
        [Z, Z, Z, Z, -I3, Z, Z, Z, Z, I3],
    ]
    J = torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)
    # the residual of imu_residual from the same intermediates
    r = torch.cat([_mv(RiT, a_p) - dp_c, 2.0 * E[..., 1:4], _mv(RiT, a_v) - dv_c,
                   ba_j - ba_i, bg_j - bg_i], dim=-1)
    return _mv(pre.sqrt_info, r), pre.sqrt_info @ J


def _imu_args(state: WindowState):
    s = state
    return (s.p[:-1], s.q[:-1], s.v[:-1], s.ba[:-1], s.bg[:-1],
            s.p[1:], s.q[1:], s.v[1:], s.ba[1:], s.bg[1:])


def _imu_valid(pres: Preintegration, max_dt: float):
    return (pres.dt_sum < max_dt) & (pres.dt_sum > 1e-6)


def imu_blocks(state: WindowState, pres: Preintegration, gravity: torch.Tensor,
               max_dt: float = 10.0) -> ImuBlocks:
    """The F-1 consecutive-frame IMU factors (`pres` carries a leading
    [F-1] batch).  Intervals longer than `max_dt` seconds are masked
    (estimator.cpp:772: skip if sum_dt > 10), and so are empty ones (zero
    covariance ⇒ a near-infinite whitener)."""
    r, J = _imu_chain(pres, *_imu_args(state), gravity)
    valid = _imu_valid(pres, max_dt)
    m = valid[:, None].to(r.dtype)
    return ImuBlocks(r=r * m, J=J * m[..., None], valid=valid)


def imu_residuals(state: WindowState, pres: Preintegration, gravity: torch.Tensor,
                  max_dt: float = 10.0) -> torch.Tensor:
    """Residual-only IMU evaluation [F-1, 15], masked as `imu_blocks`."""
    r = imu_residual(pres, *_imu_args(state), gravity)
    return r * _imu_valid(pres, max_dt)[:, None].to(r.dtype)


def _onehot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    # a comparison, not F.one_hot: that validates its input's range on the host
    return (idx[:, None] == torch.arange(n, device=idx.device)[None, :]).to(dtype)


def densify_projection(blocks: ProjBlocks, obs: FeatureObs, layout: Layout):
    """Scatter per-factor [2, 20] Jacobian blocks into dense rows
    [L, F, 2, dim_x] + the landmark column [L, F, 2]: the pose_j block at its
    own frame (einsum with I_F), the pose_i block at the anchor frame (einsum
    with the anchor one-hot); extrinsic/td columns are fixed."""
    L, F = blocks.valid.shape
    dt = blocks.r.dtype
    J = blocks.J
    eyeF = torch.eye(F, dtype=dt, device=J.device)
    pose_part = (torch.einsum("lfrk,fg->lfrgk", J[..., 6:12], eyeF)
                 + torch.einsum("lfrk,lg->lfrgk", J[..., 0:6], _onehot(obs.anchor, F, dt))
                 ).reshape(L, F, 2, 6 * F)
    sb_zeros = torch.zeros((L, F, 2, 9 * F), dtype=dt, device=J.device)
    J_dense = torch.cat([pose_part, sb_zeros, J[..., 12:18], J[..., 18:19]], dim=-1)
    return J_dense, J[..., 19]


class ReloBlocks(NamedTuple):
    r: torch.Tensor  # [L, 2] whitened residuals
    J: torch.Tensor  # [L, 2, PROJ_DX] whitened local Jacobians
    valid: torch.Tensor  # [L] bool


def _relo_args(state: WindowState, obs: FeatureObs, relo_p, relo_q, relo_pt):
    """`_proj_chain` arguments with frame j := the relo frame (zero velocity
    and time offset on the old observation)."""
    pt_i, vel_i, toff_i = anchor_gather(obs)
    a = obs.anchor
    return (state.p[a], state.q[a], relo_p, relo_q, state.tic, state.qic, obs.inv_depth,
            state.td, pt_i, vel_i, toff_i, relo_pt, torch.zeros_like(relo_pt),
            torch.zeros_like(toff_i))


def relo_valid_mask(obs: FeatureObs, relo_valid) -> torch.Tensor:
    return relo_valid & obs.active & (obs.inv_depth > 0)


def relo_blocks(state: WindowState, obs: FeatureObs, relo_p, relo_q, relo_pt, relo_valid,
                focal: float = 460.0) -> ReloBlocks:
    """Relocalization projection factors (estimator.cpp:769-801): window
    landmarks observed in the OLD loop keyframe, whose BODY pose (relo_p,
    relo_q) is a free parameter."""
    r, J = _proj_chain(*_relo_args(state, obs, relo_p, relo_q, relo_pt))
    valid = relo_valid_mask(obs, relo_valid)
    m = valid[:, None].to(r.dtype) * (focal / 1.5)
    return ReloBlocks(r=r * m, J=J * m[..., None], valid=valid)


def relo_residuals(state: WindowState, obs: FeatureObs, relo_p, relo_q, relo_pt, relo_valid,
                   focal: float = 460.0):
    """Residual-only relo-factor evaluation for cost checks: (r [L, 2], valid)."""
    r = _proj_chain(*_relo_args(state, obs, relo_p, relo_q, relo_pt), jac=False)
    valid = relo_valid_mask(obs, relo_valid)
    return r * (valid[:, None].to(r.dtype) * (focal / 1.5)), valid


def densify_relo(blocks: ReloBlocks, obs: FeatureObs, layout: Layout):
    """Scatter relo-factor Jacobians into dense rows [L, 2, dim_x + 6]: the
    anchor-pose block at the anchor frame, the relo-pose block in the 6
    APPENDED columns, extrinsic/td at their fixed offsets."""
    L = blocks.valid.shape[0]
    F = layout.F
    dt = blocks.r.dtype
    J = blocks.J
    pose_part = torch.einsum("lrk,lg->lrgk", J[..., 0:6],
                             _onehot(obs.anchor, F, dt)).reshape(L, 2, 6 * F)
    sb_zeros = torch.zeros((L, 2, 9 * F), dtype=dt, device=J.device)
    J_dense = torch.cat([pose_part, sb_zeros, J[..., 12:18], J[..., 18:19], J[..., 6:12]], dim=-1)
    return J_dense, J[..., 19]


def densify_imu(blocks: ImuBlocks, layout: Layout) -> torch.Tensor:
    """Scatter IMU factor Jacobians into dense rows [F-1, 15, dim_x].
    Interval k's columns are pose k, sb k, pose k+1, sb k+1: einsums with
    the one-hots of k and k+1."""
    Fm1 = blocks.r.shape[0]
    F = layout.F
    J = blocks.J
    k = torch.arange(Fm1, device=J.device)
    at_k, at_k1 = _onehot(k, F, J.dtype), _onehot(k + 1, F, J.dtype)

    def place(Ji, Jj):
        return (torch.einsum("kri,kf->krfi", Ji, at_k)
                + torch.einsum("kri,kf->krfi", Jj, at_k1)).flatten(-2)

    return torch.cat([place(J[..., 0:6], J[..., 15:21]), place(J[..., 6:15], J[..., 21:30]),
                      J.new_zeros((Fm1, 15, layout.dim_x - 15 * F))], dim=-1)
