"""Problem containers and local-coordinate layout for the window solver.

PyTorch counterpart of `vins_tpu/solver/problem.py`.  The reference's Ceres
parameter blocks (estimator.cpp:676-801) become one fixed-shape set of
tensors, and the local (tangent) coordinates one packed vector:

    [ poses 6·F | speed/bias 9·F | extrinsic 6 | td 1 ]  → dim_x = 15·F + 7

followed by a separate landmark block (inverse depths, eliminated by Schur
complement).  F = window+1 frames.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie


class Layout:
    """Static index layout of the packed tangent vector (all Python ints)."""

    def __init__(self, frames: int):
        self.F = frames
        self.dim_pose = 6 * frames
        self.dim_sb = 9 * frames
        self.ext_off = 15 * frames
        self.td_off = 15 * frames + 6
        self.dim_x = 15 * frames + 7

    def pose_off(self, f):
        return 6 * f

    def sb_off(self, f):
        return 6 * self.F + 9 * f


def _qid(shape, dtype, device) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 0:1] = 1.0
    return q


class WindowState(NamedTuple):
    """All optimizable window states (estimator.h:74-90 Ps/Rs/Vs/Bas/Bgs +
    ric/tic + td)."""

    p: torch.Tensor  # [F, 3] position of body in world
    q: torch.Tensor  # [F, 4] world←body quaternion [w,x,y,z]
    v: torch.Tensor  # [F, 3]
    ba: torch.Tensor  # [F, 3]
    bg: torch.Tensor  # [F, 3]
    tic: torch.Tensor  # [3] body←camera translation
    qic: torch.Tensor  # [4] body←camera rotation
    td: torch.Tensor  # [] time offset

    @staticmethod
    def identity(frames: int, dtype=torch.float64, device="cpu") -> "WindowState":
        z = torch.zeros((frames, 3), dtype=dtype, device=device)
        return WindowState(
            p=z, q=_qid((frames,), dtype, device), v=z, ba=z, bg=z,
            tic=torch.zeros(3, dtype=dtype, device=device), qic=_qid((), dtype, device),
            td=torch.zeros((), dtype=dtype, device=device),
        )


def where_state(cond, a: WindowState, b: WindowState) -> WindowState:
    """Field by field `torch.where(cond, a, b)` for a [] bool tensor."""
    return WindowState(*[torch.where(cond, x, y) for x, y in zip(a, b)])


def state_boxplus(s: WindowState, dx: torch.Tensor, layout: Layout) -> WindowState:
    """Apply a packed tangent step (pose ⊞ per pose_local_parameterization)."""
    F = layout.F
    d_pose = dx[: 6 * F].reshape(F, 6)
    d_sb = dx[6 * F: 15 * F].reshape(F, 9)
    d_ext = dx[layout.ext_off: layout.ext_off + 6]
    p, q = lie.pose_boxplus(s.p, s.q, d_pose[:, :3], d_pose[:, 3:])
    tic, qic = lie.pose_boxplus(s.tic, s.qic, d_ext[:3], d_ext[3:])
    return WindowState(
        p=p, q=q,
        v=s.v + d_sb[:, 0:3], ba=s.ba + d_sb[:, 3:6], bg=s.bg + d_sb[:, 6:9],
        tic=tic, qic=qic, td=s.td + dx[layout.td_off],
    )


def _qdiff(q, ql):
    e = lie.qmul(lie.qconj(ql), q)
    e = torch.where(e[..., :1] >= 0, e, -e)
    return 2.0 * e[..., 1:]


def state_boxminus(s: WindowState, lin: WindowState, layout: Layout) -> torch.Tensor:
    """Packed tangent difference s ⊟ lin, quaternion-aware
    (marginalization_factor.cpp:345-363: dx_rot = 2·vec(q_lin⁻¹ ⊗ q), sign
    flipped so w ≥ 0)."""
    d_pose = torch.cat([s.p - lin.p, _qdiff(s.q, lin.q)], dim=-1)  # [F,6]
    d_sb = torch.cat([s.v - lin.v, s.ba - lin.ba, s.bg - lin.bg], dim=-1)  # [F,9]
    d_ext = torch.cat([s.tic - lin.tic, _qdiff(s.qic, lin.qic)])
    return torch.cat([d_pose.reshape(-1), d_sb.reshape(-1), d_ext, (s.td - lin.td)[None]])


class FeatureObs(NamedTuple):
    """Dense window observation tensor — the solver-facing view of the
    feature database (feature_manager.h:52-74).

    Slot l observes frame f iff valid[l, f]; anchor[l] is the first observing
    frame (the inverse-depth anchor).  `toff[l, f]` is the per-observation
    time origin: the factor shifts points by (td − toff)·vel
    (projection_td_factor.cpp:50-52)."""

    pt: torch.Tensor  # [L, F, 2] normalized-plane coordinates
    vel: torch.Tensor  # [L, F, 2] normalized-plane velocity
    toff: torch.Tensor  # [L, F]
    valid: torch.Tensor  # [L, F] bool
    anchor: torch.Tensor  # [L] int64 first observing frame
    inv_depth: torch.Tensor  # [L] inverse depth in anchor frame
    active: torch.Tensor  # [L] bool — participates in optimization

    @staticmethod
    def empty(max_landmarks: int, frames: int, dtype=torch.float64,
              device="cpu") -> "FeatureObs":
        L, F = max_landmarks, frames
        z = torch.zeros((L, F, 2), dtype=dtype, device=device)
        return FeatureObs(
            pt=z, vel=z, toff=torch.zeros((L, F), dtype=dtype, device=device),
            valid=torch.zeros((L, F), dtype=torch.bool, device=device),
            anchor=torch.zeros((L,), dtype=torch.int64, device=device),
            inv_depth=torch.full((L,), 0.2, dtype=dtype, device=device),
            active=torch.zeros((L,), dtype=torch.bool, device=device),
        )


class Prior(NamedTuple):
    """Marginalization prior: r(x) = r0 + J·(x ⊟ lin)
    (marginalization_factor.cpp:321-381)."""

    J: torch.Tensor  # [R, dim_x]
    r0: torch.Tensor  # [R]
    lin: WindowState  # linearization point (current window layout)
    valid: torch.Tensor  # [] bool

    @staticmethod
    def empty(layout: Layout, dtype=torch.float64, device="cpu") -> "Prior":
        n = layout.dim_x
        return Prior(
            J=torch.zeros((n, n), dtype=dtype, device=device),
            r0=torch.zeros((n,), dtype=dtype, device=device),
            lin=WindowState.identity(layout.F, dtype, device),
            valid=torch.zeros((), dtype=torch.bool, device=device),
        )


def prior_residual(prior: Prior, s: WindowState, layout: Layout) -> torch.Tensor:
    """Evaluate the prior residual at state s (zero when invalid)."""
    dx = state_boxminus(s, prior.lin, layout)
    r = prior.r0 + prior.J @ dx
    return torch.where(prior.valid, r, torch.zeros_like(r))
