"""Masked Levenberg-Marquardt solver with Schur landmark elimination.

PyTorch counterpart of `vins_tpu/solver/gn.py`, which replaces Ceres
(estimator.cpp:803-818: DENSE_SCHUR + DOGLEG, ≤8 iterations) with a
fixed-iteration LM loop.  Per iteration: relinearize every factor, Cauchy
IRLS weights on the projection factors (CauchyLoss(1.0), estimator.cpp:694),
dense normal equations by einsum, Schur elimination of the inverse depths,
a Jacobi-preconditioned Cholesky solve of the reduced camera system, and an
accept/reject by `torch.where`.  No step reads a value back to the host:
the loop has a fixed length, Cholesky is `cholesky_ex` (a failed factor
gives NaN) and the solves are triangular.

`axis_name` is the landmark-sharded solve's axis (a `parallel/sharded.py`
`Axis`, in place of JAX's mesh-axis name): the landmark axis of `obs` is
this rank's block, and the projection terms of the cost, of H/b and of the
Schur complement are summed over the axis by `axis_name.psum` (one fused
all-reduce each, as JAX's psums); the IMU and prior terms are replicated.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie
from ..core.linalg import cho_solve, cholesky_nan
from ..imu.preintegration import Preintegration
from .factors import (densify_imu, densify_projection, densify_relo, imu_blocks,
                      imu_residuals, projection_blocks, projection_residuals, relo_blocks,
                      relo_residuals)
from .problem import (FeatureObs, Layout, Prior, WindowState, prior_residual, state_boxplus,
                      where_state)


class SolverOptions(NamedTuple):
    iters: int = 8
    mu_init: float = 1e-4
    mu_up: float = 10.0
    mu_down: float = 0.3
    focal: float = 460.0
    max_imu_dt: float = 10.0


class SolveInfo(NamedTuple):
    cost0: torch.Tensor
    cost: torch.Tensor
    mu: torch.Tensor
    accepted: torch.Tensor  # [iters] bool


def _cauchy_weights(r: torch.Tensor, valid: torch.Tensor):
    """IRLS sqrt-weights for CauchyLoss(1.0): ρ(s)=log(1+s) ⇒ ρ'(s)=1/(1+s)."""
    s = torch.sum(r * r, dim=-1)
    return torch.sqrt(1.0 / (1.0 + s)) * valid.to(r.dtype), s


def compute_cost(state: WindowState, lam, obs: FeatureObs, pres: Preintegration,
                 prior: Prior, gravity, layout: Layout, opts: SolverOptions,
                 axis_name=None, relo_eval=None) -> torch.Tensor:
    """Total robustified cost at a state (for LM accept/reject).
    `relo_eval`: optional (relo_p, relo_q, relo_pt, relo_valid, relo_on)
    adding the relocalization projection factors (estimator.cpp:769-801)."""
    obs = obs._replace(inv_depth=lam)
    r, valid = projection_residuals(state, obs, opts.focal)
    s = torch.sum(r * r, dim=-1)
    sharded = [torch.sum(torch.where(valid, torch.log1p(s), 0.0))]
    if relo_eval is not None:
        relo_p, relo_q, relo_pt, relo_valid, relo_on = relo_eval
        rr, rv = relo_residuals(state, obs, relo_p, relo_q, relo_pt, relo_valid, opts.focal)
        sr = torch.sum(rr * rr, dim=-1)
        sharded.append(torch.sum(torch.where(rv, torch.log1p(sr), 0.0)))
    if axis_name is not None:
        sharded = axis_name.psum(*sharded)
    r_i = imu_residuals(state, pres, gravity, opts.max_imu_dt)
    r_pr = prior_residual(prior, state, layout)
    cost = 0.5 * (sharded[0] + torch.sum(r_i * r_i) + torch.sum(r_pr * r_pr))
    if relo_eval is not None:
        cost = cost + 0.5 * relo_on * sharded[1]
    return cost


def build_normal_equations(state: WindowState, lam, obs: FeatureObs, pres: Preintegration,
                           prior: Prior, gravity, layout: Layout, opts: SolverOptions,
                           col_mask: torch.Tensor, axis_name=None, relo_eval=None):
    """Assemble H, b and the landmark blocks (H_xl, H_ll, b_l).  With
    `relo_eval` the system has 6 extra columns (the relo pose block) and the
    relo projection factors contribute (estimator.cpp:769-801).  `col_mask`
    [dim_ext]: 1 = free, 0 = held fixed."""
    obs = obs._replace(inv_depth=lam)
    n_ext = 6 if relo_eval is not None else 0

    def pad_cols(J):
        if n_ext == 0:
            return J
        return torch.cat([J, J.new_zeros(J.shape[:-1] + (n_ext,))], dim=-1)

    proj = projection_blocks(state, obs, opts.focal)
    sw, _ = _cauchy_weights(proj.r, proj.valid)
    r_p = proj.r * sw[..., None]
    proj = proj._replace(J=proj.J * sw[..., None, None])
    J_dense, J_lam = densify_projection(proj, obs, layout)
    J_dense = pad_cols(J_dense) * col_mask   # hold inactive state columns fixed

    imu = imu_blocks(state, pres, gravity, opts.max_imu_dt)
    J_imu = pad_cols(densify_imu(imu, layout)) * col_mask

    r_prior = prior_residual(prior, state, layout)
    J_prior = pad_cols(torch.where(prior.valid, prior.J, torch.zeros_like(prior.J))) * col_mask

    Jd = J_dense.flatten(0, 2)       # [L·F·2, D]
    H = Jd.T @ Jd
    b_p = Jd.T @ r_p.reshape(-1)
    H_xl = torch.einsum("lfrd,lfr->dl", J_dense, J_lam)
    H_ll = torch.einsum("lfr,lfr->l", J_lam, J_lam)
    b_l = -torch.einsum("lfr,lfr->l", J_lam, r_p)

    if relo_eval is not None:
        relo_p, relo_q, relo_pt, relo_valid, relo_on = relo_eval
        rb = relo_blocks(state, obs, relo_p, relo_q, relo_pt, relo_valid, opts.focal)
        rsw, _ = _cauchy_weights(rb.r, rb.valid)
        rsw = rsw * relo_on  # dynamic gate: zero weight ⇒ no contribution
        r_r = rb.r * rsw[:, None]
        rb = rb._replace(J=rb.J * rsw[:, None, None])
        J_r, J_r_lam = densify_relo(rb, obs, layout)
        J_r = J_r * col_mask
        Jr = J_r.flatten(0, 1)
        H = H + Jr.T @ Jr
        b_p = b_p + Jr.T @ r_r.reshape(-1)
        H_xl = H_xl + torch.einsum("lrd,lr->dl", J_r, J_r_lam)
        H_ll = H_ll + torch.einsum("lr,lr->l", J_r_lam, J_r_lam)
        b_l = b_l - torch.einsum("lr,lr->l", J_r_lam, r_r)

    if axis_name is not None:  # one fused all-reduce of the per-shard terms
        H, b_p = axis_name.psum(H, b_p)
    Ji = J_imu.flatten(0, 1)
    H = H + Ji.T @ Ji + J_prior.T @ J_prior
    b = -(b_p + Ji.T @ imu.r.reshape(-1) + J_prior.T @ r_prior)
    # identity rows for masked columns keep H nonsingular with dx = 0 there
    H = H + torch.diag(1.0 - col_mask)
    return H, b, H_xl, H_ll, b_l


def _damped_solve(H, b, H_xl, H_ll, b_l, mu, dtype, axis_name=None):
    """Schur-reduced, Marquardt-damped, Jacobi-preconditioned solve."""
    dim_x = H.shape[0]
    eye = torch.eye(dim_x, dtype=dtype, device=H.device)
    H_d = H + mu * torch.diag(torch.diagonal(H)) + 1e-10 * eye
    H_ll_d = H_ll * (1.0 + mu)
    inv_ll = torch.where(H_ll > 1e-12, 1.0 / (H_ll_d + 1e-12), 0.0)

    S_H = (H_xl * inv_ll[None, :]) @ H_xl.T
    S_b = H_xl @ (inv_ll * b_l)
    if axis_name is not None:
        S_H, S_b = axis_name.psum(S_H, S_b)
    H_red = H_d - S_H
    b_red = b - S_b

    d = torch.sqrt(torch.clamp(torch.diagonal(H_red), min=1e-12))
    Hn = H_red / d[:, None] / d[None, :]
    bn = b_red / d
    # Cholesky jitter on the UNIT-diagonal system must clear the dtype's
    # roundoff floor (f32 needs ~1e-6; 1e-9 is below f32 eps and lets
    # near-null gauge directions blow up the step)
    jit_eps = 1e-9 if dtype == torch.float64 else 3e-6
    L = cholesky_nan(Hn + jit_eps * eye)
    dx = cho_solve(L, bn[:, None])[:, 0] / d
    d_lam = inv_ll * (b_l - H_xl.T @ dx)
    return dx, d_lam


def solve_window(state: WindowState, obs: FeatureObs, pres: Preintegration, prior: Prior,
                 gravity, layout: Layout, opts: SolverOptions = SolverOptions(),
                 estimate_extrinsic: bool = False, estimate_td: bool = False,
                 extra_diag: torch.Tensor | None = None, axis_name=None, relo=None):
    """Run the fixed-iteration LM loop; returns (state, inv_depth, info) —
    or (state, inv_depth, info, relo_p, relo_q) when `relo` is given.

    `extra_diag` [dim_x] adds to the H diagonal (gauge pinning in tests,
    soft-fixing states).  `relo` = (relo_p0, relo_q0, relo_pt [L,2],
    relo_valid [L], relo_on): adds the relocalization pose as a free 6-dim
    block (estimator.cpp:769-801); `relo_on` is a 0/1 gate so one step
    serves frames with and without a relo match.  With `axis_name` the
    landmark axis of `obs` (and of `relo`) is this rank's block of a
    landmark-sharded window."""
    dt = state.p.dtype
    dev = state.p.device
    dim_x = layout.dim_x
    with_relo = relo is not None
    n_ext = 6 if with_relo else 0

    col_mask = torch.ones((dim_x + n_ext,), dtype=dt, device=dev)
    if not estimate_extrinsic:
        col_mask[layout.ext_off: layout.ext_off + 6] = 0.0
    if not estimate_td:
        col_mask[layout.td_off:layout.td_off + 1] = 0.0
    if with_relo:
        relo_p0, relo_q0, relo_pt, relo_valid, relo_on = relo
        relo_on = torch.as_tensor(relo_on, dtype=dt, device=dev)
        col_mask = torch.cat([col_mask[:dim_x], relo_on.expand(6)])
    else:
        relo_p0 = torch.zeros(3, dtype=dt, device=dev)
        relo_q0 = torch.zeros(4, dtype=dt, device=dev)
        relo_q0[:1] = 1.0

    extra = torch.zeros((dim_x + n_ext,), dtype=dt, device=dev)
    if extra_diag is not None:
        extra[:dim_x] = extra_diag.to(dt)

    def cost_fn(state, lam, rp, rq):
        re = (rp, rq, relo_pt, relo_valid, relo_on) if with_relo else None
        return compute_cost(state, lam, obs, pres, prior, gravity, layout, opts, axis_name,
                            relo_eval=re)

    lam, rp, rq = obs.inv_depth, relo_p0, relo_q0
    cost0 = cost = cost_fn(state, lam, rp, rq)
    mu = torch.full((), opts.mu_init, dtype=dt, device=dev)
    accepted = []
    for _ in range(opts.iters):
        re = (rp, rq, relo_pt, relo_valid, relo_on) if with_relo else None
        H, b, H_xl, H_ll, b_l = build_normal_equations(
            state, lam, obs, pres, prior, gravity, layout, opts, col_mask, axis_name,
            relo_eval=re)
        H = H + torch.diag(extra)
        dx, d_lam = _damped_solve(H, b, H_xl, H_ll, b_l, mu, dt, axis_name)
        cand_state = state_boxplus(state, dx[:dim_x], layout)
        if with_relo:
            cand_rp, cand_rq = lie.pose_boxplus(rp, rq, dx[dim_x:dim_x + 3],
                                                dx[dim_x + 3:dim_x + 6])
        else:
            cand_rp, cand_rq = rp, rq
        cand_lam = lam + d_lam
        cand_cost = cost_fn(cand_state, cand_lam, cand_rp, cand_rq)
        accept = cand_cost < cost
        state = where_state(accept, cand_state, state)
        lam = torch.where(accept, cand_lam, lam)
        rp = torch.where(accept, cand_rp, rp)
        rq = torch.where(accept, cand_rq, rq)
        mu = torch.clamp(torch.where(accept, mu * opts.mu_down, mu * opts.mu_up), 1e-10, 1e8)
        cost = torch.where(accept, cand_cost, cost)
        accepted.append(accept)
    info = SolveInfo(cost0=cost0, cost=cost, mu=mu, accepted=torch.stack(accepted))
    if with_relo:
        return state, lam, info, rp, rq
    return state, lam, info
