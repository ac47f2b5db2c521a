"""Batched visual-only bundle adjustment (world-point parameterization).

PyTorch counterpart of `vins_tpu/solver/ba.py`, used by the initializer's
global SfM (initial_sfm.cpp:232-289: BA over per-frame camera poses and 3D
points, pose l fixed and the translations of l and F-1 fixed as gauge).
Fixed-iteration LM with 3×3 landmark-block Schur elimination; the reduced
camera system is a dense 6F solve.  With `axis_name` (a
`parallel/sharded.py` `Axis`) the landmarks are this rank's block: the cost,
and the four per-rank terms of the reduced system (H_xx, b_x and the Schur
complement S_H, S_b) in one fused all-reduce, are summed over the axis, and
the poses are replicated (`make_sharded_ba`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie
from ..core.linalg import cho_solve, cholesky_nan, inv3x3
from .factors import project


class BAState(NamedTuple):
    p: torch.Tensor  # [F,3] camera position in world
    q: torch.Tensor  # [F,4] world←camera quaternion
    pts: torch.Tensor  # [L,3] world points


def reprojection(p, q, X, obs, jac: bool = True):
    """Residuals Pc[:2]/z − obs of world points X seen from camera poses
    (p, q) (world←cam), broadcasting over leading dims, and their Jacobians
    [..., 2, 9] over [dp, dθ, dX] (pose ⊞ as `lie.pose_boxplus`)."""
    RT = lie.q2R(q).transpose(-1, -2)
    Pc = (RT @ (X - p)[..., None])[..., 0]
    uv, dproj = project(Pc)
    if not jac:
        return uv - obs
    RT = RT.expand(Pc.shape + (3,))
    return uv - obs, dproj @ torch.cat([-RT, lie.skew(Pc), RT], dim=-1)


def _blocks(state: BAState, obs, valid, jac: bool = True):
    """Residuals (+ local Jacobians [L,F,2,9]) over the [L,F] factor grid."""
    out = reprojection(state.p[None], state.q[None], state.pts[:, None], obs, jac)
    m = valid[..., None].to(state.p.dtype)
    if not jac:
        return out * m
    return out[0] * m, out[1] * m[..., None]


def _cost(state: BAState, obs, valid, axis_name=None):
    r = _blocks(state, obs, valid, jac=False)
    c = torch.sum(r * r)
    return 0.5 * (c if axis_name is None else axis_name.psum(c)[0])


def _normal_eqs(state: BAState, obs, valid, pose_col_mask):
    L, F = valid.shape
    r, J = _blocks(state, obs, valid)
    Jp, Jx = J[..., 0:6], J[..., 6:9]
    eyeF = torch.eye(F, dtype=r.dtype, device=r.device)
    Jp_dense = torch.einsum("lfrk,fg->lfrgk", Jp, eyeF).reshape(L, F, 2, 6 * F) * pose_col_mask
    H_xx = torch.einsum("lfrd,lfre->de", Jp_dense, Jp_dense)
    b_x = -torch.einsum("lfrd,lfr->d", Jp_dense, r)
    H_xl = torch.einsum("lfrd,lfri->dli", Jp_dense, Jx)  # [6F,L,3]
    H_ll = torch.einsum("lfri,lfrj->lij", Jx, Jx)  # [L,3,3]
    b_l = -torch.einsum("lfri,lfr->li", Jx, r)  # [L,3]
    return H_xx, b_x, H_xl, H_ll, b_l


def _damped_solve(H_xx, b_x, H_xl, H_ll, b_l, mu, pose_col_mask, pt_mask, axis_name=None):
    F6 = H_xx.shape[0]
    dt, dev = H_xx.dtype, H_xx.device
    I3 = torch.eye(3, dtype=dt, device=dev)
    d_ll = torch.clamp(torch.diagonal(H_ll, dim1=1, dim2=2), min=1e-6)
    H_ll_d = H_ll + (mu * d_ll + 1e-8)[:, :, None] * I3
    # zero-information (invisible/fixed) landmarks get identity blocks
    H_ll_d = torch.where(pt_mask[:, None, None], H_ll_d, I3)
    inv_ll = torch.where(pt_mask[:, None, None], inv3x3(H_ll_d), 0.0)

    S_H = torch.einsum("dli,lij,elj->de", H_xl, inv_ll, H_xl)
    S_b = torch.einsum("dli,lij,lj->d", H_xl, inv_ll, b_l)
    if axis_name is not None:  # the four per-rank terms in one all-reduce
        H_xx, b_x, S_H, S_b = axis_name.psum(H_xx, b_x, S_H, S_b)
    H_red = H_xx - S_H
    b_red = b_x - S_b
    H_red = H_red + mu * torch.diag(torch.diagonal(H_red))
    H_red = H_red + torch.diag(1.0 - pose_col_mask) + 1e-9 * torch.eye(F6, dtype=dt, device=dev)
    d = torch.sqrt(torch.clamp(torch.diagonal(H_red), min=1e-12))
    Hn = H_red / d[:, None] / d[None, :]
    dx = cho_solve(cholesky_nan(Hn), (b_red / d)[:, None])[:, 0] / d
    d_pt = torch.einsum("lij,lj->li", inv_ll, b_l - torch.einsum("dli,d->li", H_xl, dx))
    return dx, d_pt


def ba_solve(state: BAState, obs, valid, fix_pose, fix_pos, pt_mask, iters: int = 10,
             mu_init: float = 1e-4, axis_name=None):
    """Fixed-iteration LM bundle adjustment.  obs [L,F,2] normalized-plane
    observations, valid [L,F], fix_pose [F] (all 6 dof held), fix_pos [F]
    (translation held), pt_mask [L] (landmarks to optimize).  Returns
    (state, final cost)."""
    F = state.p.shape[0]
    dtt = state.p.dtype
    valid = valid & pt_mask[:, None]
    keep = (1.0 - fix_pose.to(dtt))[:, None].expand(F, 6)
    pos_keep = (1.0 - fix_pos.to(dtt))[:, None]
    pose_col_mask = torch.cat([keep[:, 0:3] * pos_keep, keep[:, 3:6]], dim=1).reshape(6 * F)

    cost = _cost(state, obs, valid, axis_name)
    mu = torch.full((), mu_init, dtype=dtt, device=state.p.device)
    for _ in range(iters):
        H_xx, b_x, H_xl, H_ll, b_l = _normal_eqs(state, obs, valid, pose_col_mask)
        dx, d_pt = _damped_solve(H_xx, b_x, H_xl, H_ll, b_l, mu, pose_col_mask, pt_mask,
                                 axis_name)
        d_pose = dx.reshape(F, 6)
        p_new, q_new = lie.pose_boxplus(state.p, state.q, d_pose[:, :3], d_pose[:, 3:])
        cand = BAState(p=p_new, q=q_new, pts=state.pts + d_pt)
        cand_cost = _cost(cand, obs, valid, axis_name)
        accept = cand_cost < cost
        state = BAState(*[torch.where(accept, b_, a) for a, b_ in zip(state, cand)])
        mu = torch.clamp(torch.where(accept, mu * 0.3, mu * 10.0), 1e-10, 1e8)
        cost = torch.where(accept, cand_cost, cost)
    return state, cost
