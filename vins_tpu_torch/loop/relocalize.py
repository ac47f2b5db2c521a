"""Fast relocalization: the refined loop relative pose.

PyTorch counterpart of `vins_tpu/loop/relocalize.py` (the reference's
FAST_RELOCALIZATION path: keyframe.cpp:488-514 publishes the matched old
keyframe points, Estimator::setReloFrame pins them to a window frame,
optimization() solves a free relo pose against the window landmarks,
estimator.cpp:769-801, and double2vector turns it into the relative pose
that pose_graph::updateKeyFrameLoop adopts, estimator.cpp:597-618,
pose_graph.cpp:889-923).

The relo pose is the only free block here (the window landmarks are already
converged), so a 6-DoF Cauchy-robust Gauss-Newton with analytic 2×6
reprojection Jacobians (`solver.ba.reprojection`) recovers it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie, nplie
from ..core.linalg import spd_solve
from ..solver.ba import reprojection


class ReloResult(NamedTuple):
    p: torch.Tensor  # [3] refined OLD-keyframe camera position (current world)
    q: torch.Tensor  # [4] refined world←camera rotation
    n_inliers: torch.Tensor
    cost: torch.Tensor
    ok: torch.Tensor


def refine_relo_pose(X: torch.Tensor, x: torch.Tensor, valid: torch.Tensor, p0: torch.Tensor,
                     q0: torch.Tensor, iters: int = 8, thresh: float = 10.0 / 460.0,
                     min_inliers: int = 25, focal: float = 460.0) -> ReloResult:
    """Cauchy-robust GN over the relo camera pose (p, q) with the landmarks X
    [N,3] fixed, against the old keyframe's normalized points x [N,2].
    Residuals are scaled to pixels (sqrt_info = focal/1.5, estimator.cpp:17)
    before the Cauchy IRLS weights, which play CauchyLoss(1.0)'s role in the
    reference's relo factors (estimator.cpp:793-800)."""
    dt = X.dtype
    vf = valid.to(dt)
    w_f = focal / 1.5
    eye6 = torch.eye(6, dtype=dt, device=X.device)
    p, q = p0, q0
    for _ in range(iters):
        r, J = reprojection(p, q, X, x)  # [N,2], [N,2,9] over [dp, dθ, dX]
        r = w_f * r
        J = w_f * J[..., :6]
        s = torch.sum(r * r, dim=-1)
        w = torch.sqrt(1.0 / (1.0 + s)) * vf  # Cauchy IRLS weight per landmark
        Jw = (J * w[:, None, None]).reshape(-1, 6)
        rw = (r * w[:, None]).reshape(-1)
        H = Jw.T @ Jw + 1e-8 * eye6
        dx = -spd_solve(H, Jw.T @ rw)
        p, q = p + dx[:3], lie.qnormalize(lie.qmul(q, lie.deltaQ(dx[3:6])))

    r, z = reprojection(p, q, X, x, jac=False), lie.qrotate(lie.qconj(q), X - p)[:, 2]
    inl = (torch.linalg.vector_norm(r, dim=-1) < thresh) & (z > 0.0) & valid
    n = torch.sum(inl)
    s = torch.sum((w_f * r) ** 2, dim=-1)
    cost = torch.sum(torch.where(valid, torch.log1p(s), 0.0))
    return ReloResult(p=p, q=q, n_inliers=n, cost=cost, ok=n >= min_inliers)


def relative_pose_4dof(p_old_b, q_old_b, p_cur_b, q_cur_b):
    """relo_relative_t/q/yaw (double2vector, estimator.cpp:597-618), on the
    host: the current keyframe in the old keyframe's body frame, plus the
    yaw difference (degrees) — the refined loop edge updateKeyFrameLoop
    consumes."""
    rel_t = nplie.q2R(nplie.qconj(q_old_b)) @ (p_cur_b - p_old_b)
    rel_q = nplie.qmul(nplie.qconj(q_old_b), q_cur_b)
    rel_yaw = nplie.normalize_angle(nplie.R2ypr(nplie.q2R(q_cur_b))[0]
                                    - nplie.R2ypr(nplie.q2R(q_old_b))[0])
    return rel_t, rel_q, rel_yaw
