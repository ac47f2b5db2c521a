"""Geometric loop verification: batched PnP-RANSAC, and the keyframe's
FAST/BRIEF features with two-view corner depth.

PyTorch counterpart of `vins_tpu/loop/verify.py` (cv::solvePnPRansac in
KeyFrame::findConnection, pose_graph/src/keyframe.cpp:200-256): the current
keyframe's 3D points matched against the old keyframe's 2D points give the
old keyframe's pose.  All RANSAC hypotheses refine together (a batched
Gauss-Newton); acceptance follows the reference (> MIN_LOOP_NUM = 25
inliers, keyframe.h:16; |Δyaw| < 30°, |Δt| < 20 m, keyframe.cpp:472-480).

The RANSAC samples are drawn by Gumbel-top-k from standard Gumbel noise
that the caller passes (`gumbel`, [n_hyp, N] float32), so a test can feed
the JAX package's `jax.random.gumbel` draws.  Nothing here synchronizes the
host: a whole verification is queued on the device and read back by its
caller in one copy.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie
from ..frontend.detect import top_k_stable
from ..init.sfm import pnp_gn
from ..solver.factors import safe_z
from .brief import brief_describe, fast_detect, match_descriptors, smooth_for_brief


class PnPResult(NamedTuple):
    p: torch.Tensor  # [3] camera position (world)
    q: torch.Tensor  # [4] world←camera
    inliers: torch.Tensor  # [N]
    n_inliers: torch.Tensor
    ok: torch.Tensor


def _reproj_err(X, x, p, q):
    """Reprojection error of world points X [N,3] against observations x
    [..., N, 2] in the cameras (p [..., 3], q [..., 4]); (err, depth)."""
    Pc = lie.qrotate(lie.qconj(q)[..., None, :], X - p[..., None, :])
    z = Pc[..., 2]
    return torch.linalg.vector_norm(Pc[..., :2] / safe_z(z)[..., None] - x, dim=-1), z


def pnp_ransac(X: torch.Tensor, x: torch.Tensor, valid: torch.Tensor, p0: torch.Tensor,
               q0: torch.Tensor, gumbel: torch.Tensor, thresh: float = 10.0 / 460.0,
               min_inliers: int = 25) -> PnPResult:
    """PnP-RANSAC from the VIO camera pose (p0, q0): X [N,3] world points,
    x [N,2] normalized observations, valid [N]; `gumbel` [n_hyp, N] draws
    pick 4 distinct valid points per hypothesis; each hypothesis is 6
    Gauss-Newton steps, the best one is refined on its inliers (10 steps)."""
    dt = X.dtype
    n_hyp, N = gumbel.shape
    logits = torch.where(valid, 0.0, -torch.inf).to(torch.float32)[None, :]
    # 4-point samples: GN from the VIO pose needs no over-determination,
    # and small samples survive low inlier fractions
    _, idx = top_k_stable(gumbel.to(torch.float32) + logits, 4)
    w = torch.zeros((n_hyp, N), dtype=dt, device=X.device).scatter_(1, idx, 1.0) * valid.to(dt)
    ps, qs, _ = pnp_gn(X, x.expand(n_hyp, N, 2), w, p0.expand(n_hyp, 3),
                       q0.expand(n_hyp, 4), iters=6)
    err, z = _reproj_err(X, x, ps, qs)
    scores = torch.sum((err < thresh) & (z > 0.0) & valid, dim=1)
    # a one-element index: indexing by a 0-dim tensor would sync the host
    best = torch.argmax(scores)[None]
    p_b, q_b = ps[best][0], qs[best][0]

    err, z = _reproj_err(X, x, p_b, q_b)
    inl = (err < thresh) & (z > 0.0) & valid
    p, q, _ = pnp_gn(X, x, inl.to(dt), p_b, q_b, iters=10)
    err, z = _reproj_err(X, x, p, q)
    inliers = (err < thresh) & (z > 0.0) & valid
    n = torch.sum(inliers)
    return PnPResult(p=p, q=q, inliers=inliers, n_inliers=n, ok=n > min_inliers)


def relative_check(p_old, q_old, p_cur, q_cur, max_yaw_deg: float = 30.0, max_t: float = 20.0):
    """The reference's loop sanity gate (keyframe.cpp:472-480): relative
    position in the old body frame and relative yaw must be small."""
    rel_t = lie.q2R(lie.qconj(q_old)) @ (p_cur - p_old)
    rel_yaw = lie.normalize_angle(lie.R2ypr(lie.q2R(q_cur))[0] - lie.R2ypr(lie.q2R(q_old))[0])
    ok = (torch.abs(rel_yaw) < max_yaw_deg) & (torch.linalg.vector_norm(rel_t) < max_t)
    return rel_t, rel_yaw, ok


def triangulate_two_view(p0, R0, x0, p1, R1, x1, valid, max_reproj: float = 4.0 / 460.0,
                         min_parallax: float = 1.0 / 460.0):
    """Midpoint triangulation of matched rays x0 ↔ x1 [P,2] (normalized)
    between two known cameras (position p, world←camera R), gated by
    cheirality in both views, reprojection below `max_reproj` and ray
    parallax above `min_parallax`.  Gives the keyframe's FAST corners their
    own depth, so that verification runs corner to corner.  (X [P,3], ok)."""
    one = torch.ones((x0.shape[0], 1), dtype=x0.dtype, device=x0.device)
    d0 = torch.cat([x0, one], -1) @ R0.T  # world ray directions
    d1 = torch.cat([x1, one], -1) @ R1.T
    d0 = d0 / torch.linalg.vector_norm(d0, dim=-1, keepdim=True)
    d1 = d1 / torch.linalg.vector_norm(d1, dim=-1, keepdim=True)
    b = (p1 - p0)[None, :]
    dd = torch.sum(d0 * d1, -1)  # cos θ
    denom = torch.clamp(1.0 - dd * dd, min=1e-12)
    t0 = (torch.sum(b * d0, -1) - dd * torch.sum(b * d1, -1)) / denom
    t1 = (dd * torch.sum(b * d0, -1) - torch.sum(b * d1, -1)) / denom
    X = 0.5 * ((p0 + t0[:, None] * d0) + (p1 + t1[:, None] * d1))

    def reproj(p, R, x):
        Pc = (X - p[None]) @ R  # world → camera
        z = Pc[:, 2]
        zs = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
        return torch.linalg.vector_norm(Pc[:, :2] / zs[:, None] - x, dim=-1), z

    e0, z0 = reproj(p0, R0, x0)
    e1, z1 = reproj(p1, R1, x1)
    parallax = torch.arccos(torch.clamp(dd, -1.0, 1.0))
    ok = (valid & (z0 > 0.1) & (z1 > 0.1) & (e0 < max_reproj) & (e1 < max_reproj)
          & (parallax > min_parallax) & (t0 > 0.0) & (t1 > 0.0))
    return X, ok


def make_verify_connection(min_inliers: int = 25):
    """findConnection's device chain (keyframe.cpp:259-520): descriptor
    match → PnP-RANSAC → the old keyframe's body pose → the relative gate,
    queued as one sequence of device work with no host sync."""

    def verify(q_desc, q_valid, X, old_desc, old_valid, old_pts, p_c0, q_c0, qic, tic,
               p_cur, q_cur, gumbel):
        midx, mok = match_descriptors(q_desc, q_valid, old_desc, old_valid)
        x_old = old_pts[midx].to(X.dtype)
        res = pnp_ransac(X, x_old, mok, p_c0, q_c0, gumbel, min_inliers=min_inliers)
        # the old keyframe's BODY pose implied by PnP, in the current world
        q_old_b = lie.qmul(res.q, lie.qconj(qic))
        p_old_b = res.p - lie.qrotate(q_old_b, tic)
        rel_t, rel_yaw, rel_ok = relative_check(p_old_b, q_old_b, p_cur, q_cur)
        n_matches = torch.sum(mok)
        ok = (n_matches >= min_inliers) & res.ok & rel_ok
        return {
            "midx": midx, "mok": mok, "n_matches": n_matches,
            "inliers": res.inliers, "n_inliers": res.n_inliers,
            "pnp_ok": res.ok, "p_old_b": p_old_b, "q_old_b": q_old_b,
            "rel_t": rel_t, "rel_yaw": rel_yaw, "rel_ok": rel_ok, "ok": ok,
        }

    return verify


def keyframe_features(img, uv, camera, prev_pts, prev_desc, prev_valid, prev_p, prev_R,
                      p_cam, R_wc, max_fast: int = 256, fast_thresh: float = 20.0):
    """A new keyframe's loop features (the JAX pipeline's keyframe program,
    vins_tpu/pipeline.py:84-107): smoothing, BRIEF at the window points
    `uv` [Lw,2] (pixels), FAST corners with BRIEF, their normalized
    coordinates, matching against the previous keyframe's corners and
    two-view triangulation between the previous camera (prev_p, prev_R) and
    this one (p_cam, R_wc).  Returns (window desc [Lw,256], corners
    normalized [P,2], corner desc [P,256], corner ok [P], corner world
    points [P,3], their ok [P])."""
    sm = smooth_for_brief(img)
    wdesc = brief_describe(sm, uv)
    fpix, fok = fast_detect(img, max_pts=max_fast, threshold=fast_thresh)
    fdesc = brief_describe(sm, fpix)
    rays = camera.lift(fpix)
    fpts = rays[..., :2] / rays[..., 2:3]
    pmidx, pmok = match_descriptors(fdesc, fok, prev_desc, prev_valid)
    X3, okt = triangulate_two_view(p_cam, R_wc, fpts, prev_p, prev_R, prev_pts[pmidx], pmok)
    return wdesc, fpts, fdesc, fok, X3, okt
