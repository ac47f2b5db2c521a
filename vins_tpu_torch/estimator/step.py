"""The per-keyframe VIO device step.

PyTorch counterpart of `vins_tpu/estimator/step.py`: everything the
reference spreads over solveOdometry + double2vector + marginalization
(estimator.cpp:473-484, 530-619, 670-1003), as one sequence of device ops
with no host read-back between the blob upload and the result fetch:

  1. re-preintegrate every window interval from raw samples at the current
     bias estimates (an always-on `repropagate`),
  2. DLT-triangulate features that lack depth (feature_manager.cpp:202-257),
  3. masked LM solve with Schur landmark elimination (solver/gn.py),
  4. yaw/position re-anchoring of frame 0 (double2vector, estimator.cpp:
     530-577),
  5. failure metrics (failureDetection, estimator.cpp:621-667),
  6. the marginalization prior for the upcoming slide (MARGIN_OLD or
     MARGIN_SECOND_NEW, chosen on the host: `marg_old` is a Python bool).

The batched form (the multi-stream pipeline) vmaps the step over streams
that slide differently: there `marg_old` is a bool tensor, both priors are
computed and one is kept per stream, as JAX's `lax.cond` becomes a select
under `vmap`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie
from ..core.linalg import dlt_null_vector
from ..imu.preintegration import ImuNoise, preintegrate
from ..solver.gn import SolverOptions, solve_window
from ..solver.marginalize import marginalize_old, marginalize_second_new
from ..solver.problem import FeatureObs, Layout, Prior, WindowState


class StepResult(NamedTuple):
    state: WindowState  # post-solve, re-anchored, PRE-slide
    inv_depth: torch.Tensor  # [L] post-solve inverse depths
    prior: Prior  # prior for the slid window
    cost0: torch.Tensor
    cost: torch.Tensor
    fail_imu: torch.Tensor  # [] bool: bias blow-up (Ba > 2.5 or Bg > 1.0)
    fail_jump: torch.Tensor  # [] bool: position jump vs last state
    # refined relocalization BODY pose (same world/gauge as `state`); None
    # when the step was built without the relo block
    relo_p: torch.Tensor | None = None
    relo_q: torch.Tensor | None = None


def where_prior(c: torch.Tensor, a: Prior, b: Prior) -> Prior:
    """a where c, else b, field by field; c is a bool of the leading dims
    (0-dim for one stream, [S] for stacked priors)."""
    def pick(x, y):
        return torch.where(c.reshape(c.shape + (1,) * (x.dim() - c.dim())), x, y)

    return Prior(J=pick(a.J, b.J), r0=pick(a.r0, b.r0),
                 lin=WindowState(*[pick(x, y) for x, y in zip(a.lin, b.lin)]),
                 valid=pick(a.valid, b.valid))


def triangulate_depths(state: WindowState, obs: FeatureObs) -> torch.Tensor:
    """Masked multi-view DLT depth in each landmark's anchor camera
    (feature_manager.cpp:202-257), with the INIT_DEPTH=5 clamp (:251-254)."""
    dt = state.p.dtype
    p_c = state.p + lie.qrotate(state.q, state.tic)     # world←cam
    R_c = lie.q2R(lie.qmul(state.q, state.qic))         # [F,3,3]
    R_a = R_c[obs.anchor]
    p_a = p_c[obs.anchor]
    # X_f = R_cfᵀ R_ca · X_a + R_cfᵀ (p_ca − p_cf) — per (landmark, frame)
    R_rel = torch.einsum("fki,lkj->lfij", R_c, R_a)
    t_rel = torch.einsum("fki,lfk->lfi", R_c, p_a[:, None, :] - p_c[None, :, :])
    P = torch.cat([R_rel, t_rel[..., None]], dim=-1)  # [L,F,3,4]
    r0 = obs.pt[..., 0:1] * P[..., 2, :] - P[..., 0, :]
    r1 = obs.pt[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    m = obs.valid[..., None].to(dt)
    y = dlt_null_vector(torch.cat([r0 * m, r1 * m], dim=1))
    # X_a = dir_a · d with dir_a = [pt_a, 1]; DLT solves [X_a; 1] ∝ y
    w = torch.where(torch.abs(y[:, 3]) < 1e-12, 1e-12, y[:, 3])
    depth = y[:, 2] / w
    depth = torch.where(depth < 0.1, 5.0, depth)  # INIT_DEPTH fallback
    return 1.0 / depth


def reanchor_yaw(state: WindowState, origin_p0, origin_q0):
    """double2vector's gauge fix (estimator.cpp:530-577): rotate/translate the
    window so frame 0 keeps its pre-solve yaw and position.  Returns (state,
    (rot_diff, q_diff, p0_new, origin_p0)); the transform also applies to
    the relo pose block (:586-595)."""
    origin_R0 = lie.q2R(origin_q0)
    ypr_origin = lie.R2ypr(origin_R0)
    R0_new = lie.q2R(state.q[0])
    ypr_new = lie.R2ypr(R0_new)
    y_diff = ypr_origin[0] - ypr_new[0]
    zero = torch.zeros_like(y_diff)
    rot_diff = lie.ypr2R(torch.stack([y_diff, zero, zero]))
    # gimbal-lock guard (:541-546): use the full relative rotation
    singular = (torch.abs(torch.abs(ypr_origin[1]) - 90.0) < 1.0) | (
        torch.abs(torch.abs(ypr_new[1]) - 90.0) < 1.0)
    rot_diff = torch.where(singular, origin_R0 @ R0_new.T, rot_diff)
    q_diff = lie.R2q(rot_diff)

    p0_new = state.p[0]
    p = (state.p - p0_new) @ rot_diff.T + origin_p0
    q = lie.qnormalize(lie.qmul(q_diff, state.q))
    v = state.v @ rot_diff.T
    return state._replace(p=p, q=q, v=v), (rot_diff, q_diff, p0_new, origin_p0)


def make_vio_step(layout: Layout, noise: ImuNoise, opts: SolverOptions,
                  estimate_extrinsic: bool = False, estimate_td: bool = False,
                  axis_name=None, with_relo: bool = False):
    """Build the per-frame step for a fixed window layout.  With `axis_name`
    (a `parallel/sharded.py` `Axis`) the landmark axis of `obs` and
    `needs_tri` is this rank's block: the solve and the marginalization sum
    over the axis, triangulation stays local, and the re-anchor, the failure
    flags and `marginalize_second_new` are replicated.

    With `with_relo`, the step takes 5 extra trailing arguments (relo_p0
    [3], relo_q0 [4], relo_pt [L,2], relo_valid [L], relo_on []) and jointly
    optimizes the relo pose inside the window solve (estimator.cpp:769-801);
    `relo_on` gates the factors, so the same step serves frames without a
    match."""

    def vio_step(state: WindowState, imu_dt, imu_acc, imu_gyr, imu_mask, obs: FeatureObs,
                 needs_tri, prior: Prior, gravity, marg_old: bool, last_p,
                 *relo_args) -> StepResult:
        # 1. preintegrate every interval at the current biases
        pres = preintegrate(imu_dt, imu_acc, imu_gyr, state.ba[:-1], state.bg[:-1],
                            noise, imu_mask)

        # 2. triangulate missing depths at the pre-solve states
        lam_tri = triangulate_depths(state, obs)
        obs2 = obs._replace(inv_depth=torch.where(needs_tri & obs.active, lam_tri,
                                                  obs.inv_depth))

        # 3. solve
        origin_p0, origin_q0 = state.p[0], state.q[0]
        kw = dict(estimate_extrinsic=estimate_extrinsic, estimate_td=estimate_td,
                  axis_name=axis_name)
        if with_relo:
            solved, lam, info, relo_p, relo_q = solve_window(
                state, obs2, pres, prior, gravity, layout, opts, relo=tuple(relo_args), **kw)
        else:
            solved, lam, info = solve_window(state, obs2, pres, prior, gravity, layout,
                                             opts, **kw)
            relo_p = relo_q = None

        # 4. gauge re-anchor (applied to the relo pose too, :586-595)
        solved, (rot_diff, q_diff, p0_new, op0) = reanchor_yaw(solved, origin_p0, origin_q0)
        if with_relo:
            relo_p = rot_diff @ (relo_p - p0_new) + op0
            relo_q = lie.qnormalize(lie.qmul(q_diff, relo_q))

        # 5. failure metrics (estimator.cpp:621-667)
        F = layout.F
        norm = torch.linalg.vector_norm
        fail_imu = (norm(solved.ba[F - 1]) > 2.5) | (norm(solved.bg[F - 1]) > 1.0)
        dp = solved.p[F - 1] - last_p
        fail_jump = (norm(dp) > 5.0) | (torch.abs(dp[2]) > 1.0)

        # 6. marginalize for the slide (a bool tensor: both, one kept)
        def old():
            return marginalize_old(solved, obs2._replace(inv_depth=lam), pres, prior, gravity,
                                   layout, focal=opts.focal, max_imu_dt=opts.max_imu_dt,
                                   axis_name=axis_name)

        if torch.is_tensor(marg_old):
            prior_new = where_prior(marg_old, old(), marginalize_second_new(prior, layout))
        elif marg_old:
            prior_new = old()
        else:
            prior_new = marginalize_second_new(prior, layout)
        return StepResult(state=solved, inv_depth=lam, prior=prior_new, cost0=info.cost0,
                          cost=info.cost, fail_imu=fail_imu, fail_jump=fail_jump,
                          relo_p=relo_p, relo_q=relo_q)

    return vio_step
