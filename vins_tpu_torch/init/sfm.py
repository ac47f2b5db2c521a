"""Global structure-from-motion for initialization.

PyTorch counterpart of `vins_tpu/init/sfm.py` (GlobalSFM::construct,
initial_sfm.cpp:117-312): from a reference frame l at the identity pose and
the relative pose l ↔ newest, sweep PnP + triangulation forward and back,
then run full visual BA.  The reference's dynamic point bookkeeping is
masked fixed-shape tensors; cv::solvePnP is a Gauss-Newton pose refinement;
triangulations are DLT null vectors (inverse iteration on the 4×4 normal
matrix).  The reference frame l is a host int here, so the sweeps branch in
Python where the JAX package gates with `where`.

All poses here are CAMERA poses (world←camera), like the reference's sfm.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie
from ..core.linalg import dlt_null_vector, spd_solve
from ..solver.ba import BAState, ba_solve, reprojection


def _dehomog(Xh):
    w = Xh[..., 3]
    return Xh[..., :3] / torch.where(torch.abs(w) < 1e-12, 1e-12, w)[..., None]


def _cam_depth(p, q, X):
    """Depth of world points X [..., L, 3] in camera (p, q)."""
    return lie.qrotate(lie.qconj(q)[..., None, :], X - p[..., None, :])[..., 2]


def triangulate_pair(p_a, q_a, p_b, q_b, x_a, x_b):
    """Batched two-view DLT triangulation (initial_sfm.cpp:5-19) of [L,2]
    normalized observations in camera poses a and b (world←cam).  Returns
    world points [L,3] and positive-depth validity."""

    def proj_rows(p, q, x):
        R = lie.q2R(lie.qconj(q))  # cam←world rotation
        P = torch.cat([R, (-R @ p)[:, None]], dim=1)  # [3,4]
        r0 = x[:, 0:1] * P[2][None] - P[0][None]
        r1 = x[:, 1:2] * P[2][None] - P[1][None]
        return torch.stack([r0, r1], dim=1)  # [L,2,4]

    A = torch.cat([proj_rows(p_a, q_a, x_a), proj_rows(p_b, q_b, x_b)], dim=1)
    X = _dehomog(dlt_null_vector(A))
    return X, (_cam_depth(p_a, q_a, X) > 0.1) & (_cam_depth(p_b, q_b, X) > 0.1)


def triangulate_multiview(p_wc, q_wc, obs, valid):
    """Masked multi-view DLT (feature_manager.cpp:202-257 over all observing
    frames): camera poses [F,3]/[F,4], obs [L,F,2], valid [L,F].  Returns
    world points [L,3] + ok mask."""
    dt = p_wc.dtype
    R_cw = lie.q2R(lie.qconj(q_wc))  # [F,3,3]
    t_cw = -torch.einsum("fij,fj->fi", R_cw, p_wc)
    P = torch.cat([R_cw, t_cw[..., None]], dim=-1)  # [F,3,4]
    r0 = obs[..., 0:1] * P[None, :, 2] - P[None, :, 0]
    r1 = obs[..., 1:2] * P[None, :, 2] - P[None, :, 1]
    m = valid[..., None].to(dt)
    X = _dehomog(dlt_null_vector(torch.cat([r0 * m, r1 * m], dim=1)))
    z = torch.einsum("fij,lj->lfi", R_cw, X)[..., 2] + t_cw[None, :, 2]
    nobs = torch.sum(valid, dim=1)
    ok = (nobs >= 2) & (torch.sum((z > 0.1) & valid, dim=1) == nobs)
    return X, ok


def pnp_gn(X, x, w, p0, q0, iters: int = 10):
    """Gauss-Newton PnP from an initial pose (cv::solvePnP iterative,
    initial_sfm.cpp:22-72), fixed iterations, masked points.  X [L,3] world
    points; x [..., L, 2] observations, w [..., L] weights (0 = unused),
    p0 [..., 3], q0 [..., 4] camera poses (world←cam): leading dims are
    poses solved independently.  Returns (p, q, ok: ≥15 points,
    initial_sfm.cpp:38)."""
    batch = p0.shape[:-1]
    xb, wb = x.reshape((-1,) + x.shape[-2:]), w.reshape((-1,) + w.shape[-1:])
    p, q = p0.reshape(-1, 3), q0.reshape(-1, 4)
    eye6 = torch.eye(6, dtype=p0.dtype, device=p0.device)

    for _ in range(iters):
        r, J = reprojection(p[:, None], q[:, None], X, xb)          # [B,L,2], [B,L,2,9]
        wr = wb[..., None]
        r = (r * wr).reshape(r.shape[0], -1)
        J = (J[..., :6] * wr[..., None]).reshape(J.shape[0], -1, 6)  # [B,2L,6]
        Jt = J.transpose(-1, -2)
        dx = spd_solve(Jt @ J + 1e-8 * eye6, -(Jt @ r[..., None])[..., 0])
        p, q = lie.pose_boxplus(p, q, dx[:, 0:3], dx[:, 3:6])
    ok = torch.sum(wb > 0, dim=-1) >= 15
    return p.reshape(batch + (3,)), q.reshape(batch + (4,)), ok.reshape(batch)


class SfmResult(NamedTuple):
    p_wc: torch.Tensor  # [F,3] camera poses
    q_wc: torch.Tensor  # [F,4]
    pts: torch.Tensor  # [L,3] world points
    has_pt: torch.Tensor  # [L] bool
    ok: torch.Tensor  # [] bool


def construct_sfm(obs, valid, l: int, R_rel, t_rel, ba_iters: int = 12) -> SfmResult:
    """GlobalSFM::construct (:117-312) with the same sweep order: obs
    [L,F,2] normalized tracks, valid [L,F], l the reference frame (identity
    pose), (R_rel [3,3], t_rel [3]) the pose of frame F-1 in frame l (unit
    scale)."""
    L, F, _ = obs.shape
    dt, dev = obs.dtype, obs.device
    l = int(l)
    p = torch.zeros((F, 3), dtype=dt, device=dev)
    q = torch.zeros((F, 4), dtype=dt, device=dev)
    q[:, 0] = 1.0
    p[F - 1] = t_rel
    q[F - 1] = lie.R2q(R_rel)
    pts = torch.zeros((L, 3), dtype=dt, device=dev)
    has = torch.zeros((L,), dtype=torch.bool, device=dev)

    def add_points(pts, has, i, j):
        """Triangulate landmarks seen in frames i and j that lack points."""
        sel = valid[:, i] & valid[:, j] & ~has
        X, ok = triangulate_pair(p[i], q[i], p[j], q[j], obs[:, i], obs[:, j])
        new = sel & ok
        return torch.where(new[:, None], X, pts), has | new

    def pnp_update(i, init):
        w = (valid[:, i] & has).to(dt)
        p_i, q_i, okp = pnp_gn(pts, obs[:, i], w, p[init], q[init])
        p[i] = torch.where(okp, p_i, p[i])
        q[i] = torch.where(okp, q_i, q[i])

    # sweep 1: forward from l — PnP on i (init from i-1), then tri(i, F-1);
    # the i = l iteration performs the seed triangulation l ↔ F-1 (:156-160)
    for i in range(l, F - 1):
        if i > l:
            pnp_update(i, i - 1)
        pts, has = add_points(pts, has, i, F - 1)
    # sweep 2: tri(l, i) for l < i < F-1 (:181-196)
    for i in range(l + 1, F - 1):
        pts, has = add_points(pts, has, l, i)
    # sweep 3: backward from l — PnP init from i+1, then tri(i, l) (:198-217)
    for i in range(l - 1, -1, -1):
        pnp_update(i, i + 1)
        pts, has = add_points(pts, has, i, l)
    # sweep 4: triangulate leftovers from all their observations (:219-230)
    X_all, ok_all = triangulate_multiview(p, q, obs, valid)
    new = ~has & ok_all & (torch.sum(valid, dim=1) >= 2)
    pts = torch.where(new[:, None], X_all, pts)
    has = has | new

    # full BA (:232-289): pose l fixed, translations of l and F-1 fixed
    frame_ids = torch.arange(F, device=dev)
    fix_pose = frame_ids == l
    st, _ = ba_solve(BAState(p=p, q=q, pts=pts), obs, valid & has[:, None], fix_pose=fix_pose,
                     fix_pos=fix_pose | (frame_ids == F - 1), pt_mask=has, iters=ba_iters)
    return SfmResult(p_wc=st.p, q_wc=st.q, pts=st.pts, has_pt=has, ok=torch.sum(has) >= 10)
