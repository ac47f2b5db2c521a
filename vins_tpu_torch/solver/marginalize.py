"""Square-root (QR) marginalization → linear prior factor.

PyTorch counterpart of `vins_tpu/solver/marginalize.py` (the reference's
MarginalizationInfo, marginalization_factor.cpp:89-318):

  * MARGIN_OLD (estimator.cpp:826-933): drop frame 0's pose + speed/bias
    and every landmark anchored at frame 0; the information of the prior,
    IMU factor 0→1 and the projection factors anchored at 0 folds into a new
    linear prior over the remaining states, shifted to the slid layout.
  * MARGIN_SECOND_NEW (estimator.cpp:935-999): drop only pose[F-2] from the
    existing prior.

The elimination runs in square-root form: stack the whitened factor rows,
annihilate each landmark's inverse-depth column by an orthogonal
projection, and QR-eliminate the dropped columns; the trailing triangle of R
is the new prior's (J, r0).  A QR may flip the sign of any row of R against
another implementation's: the prior's JᵀJ and Jᵀr0, and so its cost, do not
change.  Column permutations are concatenations of static slices, so no
index tensor is built on the host.  Over a landmark-sharded window the
elimination is a TSQR: each rank QR-compresses its own projection rows, the
ranks gather the triangles, and every rank takes the final QR of them with
the replicated prior and IMU rows.
"""
from __future__ import annotations

import torch

from ..imu.preintegration import Preintegration
from .factors import densify_imu, densify_projection, imu_blocks, projection_blocks
from .gn import _cauchy_weights
from .problem import FeatureObs, Layout, Prior, WindowState, prior_residual


def _eliminate_lambda_rows(J_dense, J_lam, r_p):
    """Annihilate each landmark's inverse-depth column from its own
    projection rows: project onto the orthogonal complement of u = J_lam
    (P = I − uuᵀ/uᵀu).  The projected rows carry exactly the marginal
    information on the poses.  J_dense [L,F,2,D], J_lam [L,F,2], r_p [L,F,2]
    → rows [L·2F, D], rhs [L·2F]."""
    L, F, two, D = J_dense.shape
    dt = J_dense.dtype
    u = J_lam.reshape(L, F * two)
    Jd = J_dense.reshape(L, F * two, D)
    rr = r_p.reshape(L, F * two)
    uu = torch.sum(u * u, dim=-1)
    tiny = 1e-20 if dt == torch.float64 else 1e-12
    inv_uu = torch.where(uu > tiny, 1.0 / (uu + tiny), 0.0)
    cJ = torch.einsum("lk,lkd->ld", u, Jd)
    cr = torch.einsum("lk,lk->l", u, rr)
    Jd = Jd - u[:, :, None] * (cJ * inv_uu[:, None])[:, None, :]
    rr = rr - u * (cr * inv_uu)[:, None]
    return Jd.reshape(L * F * two, D), rr.reshape(L * F * two)


def _marginal_qr(rows, rhs, m: int):
    """QR-eliminate the first `m` columns of the stacked whitened residual
    system r(dx) = rhs + rows·dx; returns the marginal factor on the
    remaining columns: (J_kept [N−m, N−m], r0_kept [N−m])."""
    A = torch.cat([rows, rhs[:, None]], dim=1)
    R = torch.linalg.qr(A, mode="r")[1]
    n = rows.shape[1]
    return R[m:n, m:n], R[m:n, n]


def _cols(A, spans):
    """Columns of A in the order of the (start, stop) spans."""
    return torch.cat([A[:, a:b] for a, b in spans], dim=1)


def marginalize_old(state: WindowState, obs: FeatureObs, pres: Preintegration, prior: Prior,
                    gravity, layout: Layout, focal: float = 460.0, max_imu_dt: float = 10.0,
                    axis_name=None) -> Prior:
    """Marginalize frame 0 (and its anchored landmarks) into a new prior in
    the slid window layout.  Only factors touching dropped variables
    contribute (marginalization_factor.cpp drop_set): the previous prior,
    IMU factor 0→1, and projection factors anchored at frame 0.  With
    `axis_name` (a `parallel/sharded.py` `Axis`) `obs` is this rank's
    landmark block and the projection rows are reduced by a TSQR."""
    F = layout.F
    dt = state.p.dtype
    dim_x = layout.dim_x

    proj = projection_blocks(state, obs, focal)
    valid = proj.valid & (obs.anchor == 0)[:, None]
    sw, _ = _cauchy_weights(proj.r, valid)
    r_p = proj.r * sw[..., None]
    proj = proj._replace(J=proj.J * sw[..., None, None], valid=valid)
    J_dense, J_lam = densify_projection(proj, obs, layout)

    imu = imu_blocks(state, pres, gravity, max_imu_dt)
    first = torch.zeros(F - 1, dtype=torch.bool, device=imu.valid.device)
    first[:1] = True
    im = (imu.valid & first)[:, None].to(r_p.dtype)
    imu_rows = densify_imu(imu._replace(J=imu.J * im[..., None]), layout).reshape(-1, dim_x)
    imu_rhs = (imu.r * im).reshape(-1)

    prior_rows = torch.where(prior.valid, prior.J, torch.zeros_like(prior.J))
    prior_rhs = prior_residual(prior, state, layout)

    # step 1: square-root-eliminate the landmark inverse depths
    proj_rows, proj_rhs = _eliminate_lambda_rows(J_dense, J_lam, r_p)

    # step 2: QR-eliminate pose0 (cols 0:6) + sb0 (cols 6F:6F+9), the kept
    # columns after them in their own order
    perm = [(0, 6), (6 * F, 6 * F + 9), (6, 6 * F), (6 * F + 9, dim_x)]
    if axis_name is not None:
        # TSQR: this rank's projection rows compressed to one [D+1, D+1]
        # triangle (rhs last), the gathered triangles stand in for them
        R_loc = torch.linalg.qr(torch.cat([_cols(proj_rows, perm), proj_rhs[:, None]], dim=1),
                                mode="r")[1]
        R_all = axis_name.all_gather(R_loc).flatten(0, 1)
        proj_rows, proj_rhs = R_all[:, :-1], R_all[:, -1]
    else:
        proj_rows = _cols(proj_rows, perm)
    rows = torch.cat([proj_rows, _cols(prior_rows, perm), _cols(imu_rows, perm)], dim=0)
    rhs = torch.cat([proj_rhs, prior_rhs, imu_rhs])
    J_k, r0_k = _marginal_qr(rows, rhs, 15)

    # step 3: the kept vector (poses 1..F-1, sbs 1..F-1, ext, td) maps to the
    # slid layout's [0:6(F-1)] ⊕ [6F:6F+9(F-1)] ⊕ tail
    R = J_k.shape[0]
    npose, nsb = 6 * (F - 1), 9 * (F - 1)
    zeros = lambda n: J_k.new_zeros((R, n))  # noqa: E731
    J_top = torch.cat([J_k[:, :npose], zeros(6), J_k[:, npose:npose + nsb], zeros(9),
                       J_k[:, npose + nsb:]], dim=1)
    J_new = torch.cat([J_top, J_k.new_zeros((dim_x - R, dim_x))], dim=0)
    r0_new = torch.cat([r0_k, r0_k.new_zeros(dim_x - R)])

    # linearization point in the slid layout: frame k+1 → k; the last frame
    # repeats (its columns are zero, so the value is irrelevant)
    roll = lambda a: torch.cat([a[1:], a[-1:]], dim=0)  # noqa: E731
    lin = WindowState(p=roll(state.p), q=roll(state.q), v=roll(state.v), ba=roll(state.ba),
                      bg=roll(state.bg), tic=state.tic, qic=state.qic, td=state.td)
    return Prior(J=J_new, r0=r0_new, lin=lin,
                 valid=torch.ones((), dtype=torch.bool, device=J_new.device))


def marginalize_second_new(prior: Prior, layout: Layout) -> Prior:
    """Drop pose[F-2] from the existing prior only (estimator.cpp:935-999),
    then move frame F-1 into F-2's slots (slideWindow MARGIN_SECOND_NEW)."""
    F = layout.F
    n = layout.dim_x
    a = 6 * (F - 2)

    # square-root drop: QR-eliminate the 6 pose columns directly on J
    rows = torch.where(prior.valid, prior.J, torch.zeros_like(prior.J))
    J_k, r0_k = _marginal_qr(_cols(rows, [(a, a + 6), (0, a), (a + 6, n)]), prior.r0, 6)

    # kept columns back in place with pose F-2 empty, then the slide's
    # address shift (estimator.cpp:969-984): frame F-1 slots → F-2 slots for
    # pose and speed/bias (the prior carries no sb of those frames; kept for
    # faithfulness)
    R = J_k.shape[0]
    sb2, sb1 = 6 * F + 9 * (F - 2), 6 * F + 9 * (F - 1)
    z = lambda m: J_k.new_zeros((R, m))  # noqa: E731
    # kept columns are [0:a] ⊕ [a+6:n]: original column c ≥ a+6 is kept c-6
    Jf = torch.cat([
        J_k[:, :a],                       # poses 0..F-3
        J_k[:, a:a + 6],                  # pose F-1 → slot F-2
        z(6),                             # pose slot F-1 emptied
        J_k[:, a + 6:sb2 - 6],            # sbs 0..F-3
        J_k[:, sb1 - 6:sb1 + 3],          # sb F-1 → slot F-2
        z(9),                             # sb slot F-1 emptied
        J_k[:, sb1 + 3:],                 # extrinsic, td
    ], dim=1)
    Jf = torch.cat([Jf, Jf.new_zeros((n - R, n))], dim=0)
    r0f = torch.cat([r0_k, r0_k.new_zeros(n - R)])

    lin = prior.lin

    def move(x):
        return torch.cat([x[:F - 2], x[F - 1:F], x[F - 1:F]], dim=0)

    lin = lin._replace(p=move(lin.p), q=move(lin.q), v=move(lin.v), ba=move(lin.ba),
                       bg=move(lin.bg))
    return Prior(J=Jf, r0=r0f, lin=lin, valid=prior.valid)
