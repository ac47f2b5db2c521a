"""Two-view relative pose from normalized-plane correspondences.

PyTorch counterpart of `vins_tpu/init/relative_pose.py`: the reference's
FM_RANSAC 8-point estimator plus recoverPose
(vins_estimator/src/initial/solve_5pts.cpp:4-100, :193-228) as one
fixed-shape computation with no host sync:

  * K RANSAC hypotheses at once, each an 8-point essential solve;
  * Sampson-distance inlier scoring of all hypotheses against all points;
  * the best hypothesis refined by a weighted 8-point solve on its inliers;
  * cheirality over the 4 (R, t) decompositions by two-view depth votes.

The hypotheses' samples come from a Gumbel array passed in by the caller
(`gumbel` [K, N]), so that tests can feed the reference's exact draw.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.linalg import det3x3, smallest_eigvec, svd3x3
from ..frontend.detect import top_k_stable


class RelPose(NamedTuple):
    R: torch.Tensor          # [3,3] pose of frame j in frame i: X_i = R @ X_j + t
    t: torch.Tensor          # [3] unit norm
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # [] int
    ok: torch.Tensor         # [] bool (enough support, solve_5pts.cpp:196,221)


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _eight_point(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted 8-point essential estimate, batched: x1,x2 [..., M, 2] with
    x2ᵀ E x1 = 0, w [..., M] row weights.  Returns E [..., 3, 3] projected
    onto the essential manifold (singular values 1, 1, 0)."""
    h1 = _homog(x1)
    h2 = _homog(x2)
    A = (h2[..., :, :, None] * h1[..., :, None, :]).flatten(-2) * w[..., None]
    E = smallest_eigvec(A.transpose(-1, -2) @ A).reshape(A.shape[:-2] + (3, 3))
    U, _, Vt = svd3x3(E)
    return U[..., :, :2] @ Vt[..., :2, :]  # U·diag(1, 1, 0)·Vt


def _sampson_sq(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance of each correspondence to E: E [..., 3, 3],
    x1,x2 [N,2] → [..., N]."""
    h1 = _homog(x1)
    h2 = _homog(x2)
    Ex1 = h1 @ E.transpose(-1, -2)  # rows E @ h1
    Etx2 = h2 @ E                   # rows Eᵀ @ h2
    num = torch.sum(h2 * Ex1, dim=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _triangulate_two_view(R, t, x1, x2):
    """Two-view depths for cheirality voting, closed form: with rays
    h1 = [x1,1] in frame 1 and h2 = [x2,1] in frame 2 (X_2 = R X_1 + t),
    solve min ‖z1·R h1 − z2·h2 + t‖² as a 2×2 normal system per point.
    R [..., 3, 3], t [..., 3] batch against x1,x2 [N,2].
    Returns (X [..., N, 3] in frame 1, z1, z2)."""
    h1 = _homog(x1)
    h2 = _homog(x2)
    a = h1 @ R.transpose(-1, -2)  # [..., N, 3] = R h1
    aa = torch.sum(a * a, dim=-1)
    bb = torch.sum(h2 * h2, dim=-1)
    ab = torch.sum(a * h2, dim=-1)
    at = (a @ t[..., :, None])[..., 0]
    bt = h2 @ t[..., :, None]
    bt = bt[..., 0]
    det = aa * bb - ab * ab
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    z1 = (-at * bb + ab * bt) / det
    z2 = (-ab * at + aa * bt) / det
    return z1[..., None] * h1, z1, z2


def decompose_essential(E: torch.Tensor):
    """The 4 candidate (R, t) with X_2 = R X_1 + t (solve_5pts.cpp:4-33)."""
    U, _, Vt = svd3x3(E)
    U = U * torch.sign(det3x3(U))
    Vt = Vt * torch.sign(det3x3(Vt))
    # U·W and U·Wᵀ for W = [[0,-1,0],[1,0,0],[0,0,1]], as column moves
    UW = torch.stack([U[:, 1], -U[:, 0], U[:, 2]], dim=-1)
    UWt = torch.stack([-U[:, 1], U[:, 0], U[:, 2]], dim=-1)
    R1 = UW @ Vt
    R2 = UWt @ Vt
    t = U[:, 2]
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def solve_relative_pose(
    x1: torch.Tensor,      # [N,2] normalized-plane points in frame i
    x2: torch.Tensor,      # [N,2] matching points in frame j
    valid: torch.Tensor,   # [N] bool
    gumbel: torch.Tensor,  # [n_hyp, N] f32 standard Gumbel draws
    thresh: float = 0.3 / 460.0,  # solve_5pts.cpp:204 RANSAC threshold
    min_corres: int = 15,
    min_inliers: int = 12,
) -> RelPose:
    """MotionEstimator::solveRelativeRT equivalent (solve_5pts.cpp:193-228).

    Returns the pose of frame j expressed in frame i (the reference's
    `Rotation = R.tᵀ, Translation = -Rᵀ t`, :223-225)."""
    dt = x1.dtype
    nvalid = torch.sum(valid)

    # Gumbel-top-k over masked logits: 8 distinct valid indices per
    # hypothesis without rejection loops
    logits = torch.where(valid, 0.0, -torch.inf).to(torch.float32)[None, :]
    _, idx = top_k_stable(gumbel.to(torch.float32) + logits, 8)  # [K,8]

    Es = _eight_point(x1[idx], x2[idx], torch.ones(idx.shape, dtype=dt, device=x1.device))
    d2 = _sampson_sq(Es, x1, x2)  # [K,N]
    inl = (d2 < thresh * thresh) & valid[None, :]
    scores = torch.sum(inl, dim=1)
    # one-element index tensors: indexing by a 0-dim tensor calls .item(),
    # which would sync the host
    best = torch.argmax(scores)[None]

    # refinement: weighted 8-point on the best hypothesis's inliers
    inl_best, score_best, E_best = inl[best][0], scores[best][0], Es[best][0]
    E = _eight_point(x1, x2, inl_best.to(dt))
    inliers = (_sampson_sq(E, x1, x2) < thresh * thresh) & valid
    n_inl = torch.sum(inliers)
    # fall back to the raw best hypothesis if refinement lost support
    use_ref = n_inl >= score_best
    E = torch.where(use_ref, E, E_best)
    inliers = torch.where(use_ref, inliers, inl_best)
    n_inl = torch.maximum(n_inl, score_best)

    # cheirality vote over the 4 decompositions
    Rs, ts = decompose_essential(E)
    _, z1, z2 = _triangulate_two_view(Rs, ts, x1, x2)
    votes = torch.sum((z1 > 0) & (z2 > 0) & inliers, dim=-1)
    k = torch.argmax(votes)[None]
    R_21, t_21 = Rs[k][0], ts[k][0]

    ok = (nvalid >= min_corres) & (n_inl > min_inliers)
    return RelPose(R=R_21.T, t=-R_21.T @ t_21, inliers=inliers, n_inliers=n_inl, ok=ok)
