"""4-DoF global pose-graph optimization.

PyTorch counterpart of `vins_tpu/loop/optimize4dof.py`, the reference's
PoseGraph::optimize4DoF (pose_graph/src/pose_graph.cpp:403-579 and the cost
functors of pose_graph.h:159-248): the variables are each keyframe's yaw and
translation (pitch and roll fixed from VIO); sequential edges join each
keyframe to its 4 predecessors with the VIO relative pose, loop edges carry
the verified relative pose under a Huber(0.1) weight, and the gauge anchors
are held fixed.  Ceres' SPARSE_NORMAL_CHOLESKY × 5 iterations becomes 5
masked dense Gauss-Newton steps with a Jacobi-scaled Cholesky solve, the
normal equations assembled from closed-form per-edge 4×8 Jacobian blocks
(`method="analytic"`) or, as the oracle, from `torch.func.jacfwd` over the
whole parameter vector (`method="jacfwd"`).

Angles are DEGREES throughout, as in the reference's utility math; the
graph is float64.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import lie
from ..core.linalg import cho_solve, cholesky_nan

SEQ_BACK = 4  # sequential edges to the 4 previous keyframes (pose_graph.cpp:480)
HUBER = 0.1   # HuberLoss(0.1) on loop edges (pose_graph.cpp:431)


class GraphArrays(NamedTuple):
    """Pose-graph tensors of K slots (unused slots masked by `used`)."""

    t_vio: torch.Tensor  # [K,3] VIO translation (sequence-shifted)
    ypr_vio: torch.Tensor  # [K,3] VIO yaw/pitch/roll (degrees)
    yaw: torch.Tensor  # [K] optimized yaw (degrees)
    t: torch.Tensor  # [K,3] optimized translation
    loop_to: torch.Tensor  # [K] int matched earlier keyframe (-1 = none)
    loop_t: torch.Tensor  # [K,3] relative t in the old frame
    loop_yaw: torch.Tensor  # [K] relative yaw (degrees)
    used: torch.Tensor  # [K] bool
    fixed: torch.Tensor  # [K] bool — gauge anchor(s)


def _rot_yaw_pr(yaw, pitch, roll):
    return lie.ypr2R(torch.stack([yaw, pitch, roll], dim=-1))


def _edge_lists(g: GraphArrays):
    """Every edge as flat arrays over E = (SEQ_BACK+1)·K: (i, j, t_meas,
    yaw_meas, w, is_loop), the sequential edges i = j−k (k = 1..4, VIO
    measurements, pose_graph.cpp:480-495) then one loop-edge slot per
    keyframe (the verified relative pose, :497-514)."""
    K = g.yaw.shape[0]
    dt = g.t.dtype
    ar = torch.arange(K, device=g.t.device)
    pitch, roll = g.ypr_vio[:, 1], g.ypr_vio[:, 2]
    ei, ej, tm, ym, w = [], [], [], [], []
    for k in range(1, SEQ_BACK + 1):
        i = torch.clamp(ar - k, min=0)
        Ri_vio = _rot_yaw_pr(g.ypr_vio[i, 0], pitch[i], roll[i])
        ei.append(i)
        ej.append(ar)
        tm.append(torch.einsum("kab,ka->kb", Ri_vio, g.t_vio - g.t_vio[i]))
        ym.append(g.ypr_vio[:, 0] - g.ypr_vio[i, 0])
        w.append((g.used & g.used[i] & (ar - k >= 0)).to(dt))
    ei.append(torch.clamp(g.loop_to, min=0).to(ar.dtype))
    ej.append(ar)
    tm.append(g.loop_t)
    ym.append(g.loop_yaw)
    w.append(((g.loop_to >= 0) & g.used).to(dt))
    is_loop = torch.cat([torch.zeros(SEQ_BACK * K, dtype=torch.bool, device=ar.device),
                         torch.ones(K, dtype=torch.bool, device=ar.device)])
    return torch.cat(ei), torch.cat(ej), torch.cat(tm), torch.cat(ym), torch.cat(w), is_loop


def _residuals(g: GraphArrays, yaw, t, edges):
    """Weighted edge residuals [E,4] before the Huber weight: r_t =
    R_i(yaw_i)ᵀ(t_j − t_i) − t_meas, r_yaw = (Δyaw − Δyaw_meas)/10."""
    ei, ej, tm, ym, w, _ = edges
    Ri = _rot_yaw_pr(yaw[ei], g.ypr_vio[ei, 1], g.ypr_vio[ei, 2])
    r_t = torch.einsum("eab,ea->eb", Ri, t[ej] - t[ei]) - tm
    r_y = lie.normalize_angle(yaw[ej] - yaw[ei] - ym) / 10.0
    return torch.cat([r_t, r_y[:, None]], dim=-1) * w[:, None]


def _huber_sqrt_weight(r, is_loop):
    """sqrt(ρ'(s)) of Huber(0.1) on the loop edges, 1 elsewhere; frozen per
    linearization (IRLS)."""
    s2 = torch.sum(r * r, dim=-1)
    hub = torch.where(is_loop & (s2 > HUBER * HUBER),
                      HUBER / torch.sqrt(torch.clamp(s2, min=1e-12)), 1.0)
    return torch.sqrt(hub)


def _assemble(g: GraphArrays, yaw, t):
    """Analytic GN assembly: per-edge closed-form 4×8 Jacobian blocks (an
    edge touches poses i and j only) scatter-added into the dense normal
    equations.  Returns (H [4K,4K], b [4K], cost)."""
    K = yaw.shape[0]
    dt = t.dtype
    deg = math.pi / 180.0
    edges = _edge_lists(g)
    ei, ej, tm, ym, w, is_loop = edges
    # R_i = Rz(yaw_i)·A_i with A_i = Ry(pitch_i)·Rx(roll_i) fixed from VIO
    A = _rot_yaw_pr(torch.zeros_like(yaw[ei]), g.ypr_vio[ei, 1], g.ypr_vio[ei, 2])
    psi = yaw[ei] * deg
    c, s = torch.cos(psi), torch.sin(psi)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    RzT = torch.stack([torch.stack([c, s, zero], -1), torch.stack([-s, c, zero], -1),
                       torch.stack([zero, zero, one], -1)], -2)
    dRzT = deg * torch.stack([torch.stack([-s, c, zero], -1), torch.stack([-c, -s, zero], -1),
                              torch.stack([zero, zero, zero], -1)], -2)
    AT = A.transpose(-1, -2)
    RiT = AT @ RzT
    dtv = t[ej] - t[ei]
    r_t = (RiT @ dtv[..., None])[..., 0] - tm
    r_y = lie.normalize_angle(yaw[ej] - yaw[ei] - ym) / 10.0
    r = torch.cat([r_t, r_y[:, None]], dim=-1) * w[:, None]
    # J columns: [yaw_i, yaw_j, t_i(3), t_j(3)]
    E = ei.shape[0]
    J = torch.zeros((E, 4, 8), dtype=dt, device=t.device)
    J[:, :3, 0] = (AT @ (dRzT @ dtv[..., None]))[..., 0]
    J[:, 3, 0] = -1.0 / 10.0
    J[:, 3, 1] = 1.0 / 10.0
    J[:, :3, 2:5] = -RiT
    J[:, :3, 5:8] = RiT
    J = J * w[:, None, None]

    sw = _huber_sqrt_weight(r, is_loop)
    r = r * sw[:, None]
    J = J * sw[:, None, None]

    cols = torch.stack([ei, ej, K + 3 * ei, K + 3 * ei + 1, K + 3 * ei + 2,
                        K + 3 * ej, K + 3 * ej + 1, K + 3 * ej + 2], dim=-1)  # [E,8]
    JtJ = torch.einsum("era,erb->eab", J, J)
    Jtr = torch.einsum("era,er->ea", J, r)
    n = 4 * K
    H = torch.zeros(n * n, dtype=dt, device=t.device).index_add_(
        0, (cols[:, :, None] * n + cols[:, None, :]).reshape(-1), JtJ.reshape(-1)).reshape(n, n)
    b = torch.zeros(n, dtype=dt, device=t.device).index_add_(0, cols.reshape(-1),
                                                             -Jtr.reshape(-1))
    return H, b, torch.sum(r * r)


def optimize_4dof(g: GraphArrays, iters: int = 5, method: str = "analytic") -> GraphArrays:
    """Masked dense GN over [yaw, t] with the fixed anchors and unused slots
    held.  method="analytic" (default): the closed-form assembly, O(E);
    method="jacfwd": forward-mode AD over the full parameter vector, the
    oracle the analytic path is held against."""
    K = g.yaw.shape[0]
    dt = g.t.dtype
    n = 4 * K
    free = (g.used & ~g.fixed).to(dt)
    col_mask = torch.cat([free, free[:, None].expand(K, 3).reshape(-1)])
    eye = torch.eye(n, dtype=dt, device=g.t.device)

    def normal_eqs(yaw, t):
        if method == "analytic":
            H, b, cost = _assemble(g, yaw, t)
            # fixed / unused parameter columns: zero rows and columns
            return H * (col_mask[:, None] * col_mask[None, :]), b * col_mask, cost
        edges = _edge_lists(g)
        sw = _huber_sqrt_weight(_residuals(g, yaw, t, edges), edges[5])

        def res_of(x):
            dyaw = x[:K] * free
            dtv = x[K:].reshape(K, 3) * free[:, None]
            return (_residuals(g, yaw + dyaw, t + dtv, edges) * sw[:, None]).reshape(-1)

        x0 = torch.zeros(n, dtype=dt, device=g.t.device)
        r = res_of(x0)
        J = torch.func.jacfwd(res_of)(x0)
        return J.T @ J, -(J.T @ r), torch.sum(r * r)

    yaw, t = g.yaw, g.t
    for _ in range(iters):
        H, b, _ = normal_eqs(yaw, t)
        H = H + torch.diag(1.0 - col_mask) + 1e-8 * eye
        d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
        L = cholesky_nan(H / d[:, None] / d[None, :])
        dx = cho_solve(L, (b / d)[:, None])[:, 0] / d
        yaw = yaw + dx[:K] * free
        t = t + dx[K:].reshape(K, 3) * free[:, None]
    return g._replace(yaw=yaw, t=t)


def drift_from(g: GraphArrays, cur: int):
    """(yaw_drift, R_drift, t_drift) after a solve (pose_graph.cpp:549-557):
    the correction that maps VIO poses onto the optimized graph at
    keyframe `cur`."""
    yaw_drift = lie.normalize_angle(g.yaw[cur] - g.ypr_vio[cur, 0])
    zero = torch.zeros_like(yaw_drift)
    R_drift = lie.ypr2R(torch.stack([yaw_drift, zero, zero]))
    return yaw_drift, R_drift, g.t[cur] - R_drift @ g.t_vio[cur]
