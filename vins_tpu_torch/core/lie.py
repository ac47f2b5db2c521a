"""Quaternion / SO(3) utilities, batched over leading dims.

PyTorch counterpart of `vins_tpu/core/lie.py` (the reference's
vins_estimator/src/utility/utility.h:15-143).  Quaternions are
``[w, x, y, z]`` (Hamilton convention, active rotation).
"""
from __future__ import annotations

import math

import torch


_STRUCT = {}


def _struct(name: str, dtype, device) -> torch.Tensor:
    """Constant structure tensors of the quaternion algebra, built once per
    (dtype, device) by fills on the device (a tensor made from a Python list
    would be a blocking host-to-device copy):
      "mul"   [4, 16]: q1 @ mul = Qleft(q1) flattened, Qleft(q1) q2 = q1 ⊗ q2;
      "right" [4, 16]: q2 @ right = Qright(q2) flattened;
      "rot"   [16, 9]: (q qᵀ) flattened @ rot = |q|² R(q) flattened;
      "skew"  [3, 9]:  v @ skew = [v]× flattened."""
    key = (name, dtype, str(device))
    if key not in _STRUCT:
        entries = {
            # Qleft(q) = [[w,-x,-y,-z],[x,w,-z,y],[y,z,w,-x],[z,-y,x,w]]
            "mul": [(0, 0, 1), (1, 1, -1), (2, 2, -1), (3, 3, -1),
                    (1, 4, 1), (0, 5, 1), (3, 6, -1), (2, 7, 1),
                    (2, 8, 1), (3, 9, 1), (0, 10, 1), (1, 11, -1),
                    (3, 12, 1), (2, 13, -1), (1, 14, 1), (0, 15, 1)],
            # Qright(p) = [[w,-x,-y,-z],[x,w,z,-y],[y,-z,w,x],[z,y,-x,w]]
            "right": [(0, 0, 1), (1, 1, -1), (2, 2, -1), (3, 3, -1),
                      (1, 4, 1), (0, 5, 1), (3, 6, 1), (2, 7, -1),
                      (2, 8, 1), (3, 9, -1), (0, 10, 1), (1, 11, 1),
                      (3, 12, 1), (2, 13, 1), (1, 14, -1), (0, 15, 1)],
            "skew": [(2, 1, -1), (1, 2, 1), (2, 3, 1), (0, 5, -1), (1, 6, -1), (0, 7, 1)],
        }
        if name == "rot":
            # R·|q|² from the products q_a q_b (a, b ∈ w, x, y, z)
            w, x, y, z = 0, 1, 2, 3
            terms = {0: [(w, w, 1), (x, x, 1), (y, y, -1), (z, z, -1)],
                     1: [(x, y, 2), (w, z, -2)], 2: [(x, z, 2), (w, y, 2)],
                     3: [(x, y, 2), (w, z, 2)],
                     4: [(w, w, 1), (x, x, -1), (y, y, 1), (z, z, -1)],
                     5: [(y, z, 2), (w, x, -2)], 6: [(x, z, 2), (w, y, -2)],
                     7: [(y, z, 2), (w, x, 2)],
                     8: [(w, w, 1), (x, x, -1), (y, y, -1), (z, z, 1)]}
            entries["rot"] = [(4 * a + b, k, v) for k, ts in terms.items() for a, b, v in ts]
        rows = {"mul": 4, "right": 4, "rot": 16, "skew": 3}[name]
        cols = {"mul": 16, "right": 16, "rot": 9, "skew": 9}[name]
        t = torch.zeros((rows, cols), dtype=dtype, device=device)
        for i, j, v in entries[name]:
            t[i:i + 1, j:j + 1] = float(v)
        _STRUCT[key] = t
    return _STRUCT[key]


def qmul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2; inputs [..., 4] as [w,x,y,z]: Qleft(q1) q2,
    two matrix products whatever the batch."""
    L = (q1 @ _struct("mul", q1.dtype, q1.device)).unflatten(-1, (4, 4))
    return (L @ q2[..., None])[..., 0]


def qconj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def qrotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v [..., 3] by quaternion(s) q [..., 4]."""
    w = q[..., :1]
    u = q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    # q v q* = v + 2 w (u × v) + 2 u × (u × v)
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def deltaQ(dtheta: torch.Tensor) -> torch.Tensor:
    """Small-angle quaternion [1, dθ/2], normalized (utility.h:15-28)."""
    half = 0.5 * dtheta
    return qnormalize(torch.cat([torch.ones_like(half[..., :1]), half], dim=-1))


def qexp(dtheta: torch.Tensor) -> torch.Tensor:
    """Exact exponential map so(3) → quaternion (stable near 0)."""
    angle = torch.linalg.vector_norm(dtheta, dim=-1, keepdim=True)
    half = 0.5 * angle
    small = angle < 1e-6
    k = torch.where(small, 0.5 - angle ** 2 / 48.0,
                    torch.sin(half) / torch.where(small, torch.ones_like(angle), angle))
    return torch.cat([torch.cos(half), k * dtheta], dim=-1)


def qlog(q: torch.Tensor) -> torch.Tensor:
    """Logarithm map quaternion → so(3) rotation vector."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vnorm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(vnorm, w)
    small = vnorm < 1e-9
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-12),
                        angle / torch.where(small, torch.ones_like(vnorm), vnorm))
    return scale * v


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] → [..., 3, 3] cross-product matrix (utility.h:30-38)."""
    return (v @ _struct("skew", v.dtype, v.device)).unflatten(-1, (3, 3))


def Qleft(q: torch.Tensor) -> torch.Tensor:
    """4×4 matrix L(q) with L(q) p = q ⊗ p (utility.h:50-58)."""
    return (q @ _struct("mul", q.dtype, q.device)).unflatten(-1, (4, 4))


def Qright(p: torch.Tensor) -> torch.Tensor:
    """4×4 matrix R(p) with R(p) q = q ⊗ p (utility.h:60-68)."""
    return (p @ _struct("right", p.dtype, p.device)).unflatten(-1, (4, 4))


def q2R(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] (any norm) → rotation matrix [..., 3, 3]."""
    outer = (q[..., :, None] * q[..., None, :]).flatten(-2)
    R = outer @ _struct("rot", q.dtype, q.device)
    return (R / torch.sum(q * q, dim=-1, keepdim=True)).unflatten(-1, (3, 3))


def R2q(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] → quaternion [..., 4] (w ≥ 0), by a
    branch-free Shepperd-style pick of the most stable of four candidates."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    idx = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)

    def s4(c):
        return torch.sqrt(torch.clamp(c, min=1e-12)) * 2.0

    sw, sx, sy, sz = s4(qw2), s4(qx2), s4(qy2), s4(qz2)
    q_w = torch.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], dim=-1)
    q_x = torch.stack([(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx], dim=-1)
    q_y = torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy], dim=-1)
    q_z = torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz], dim=-1)
    q = torch.take_along_dim(torch.stack([q_w, q_x, q_y, q_z], dim=-2),
                             idx[..., None, None], dim=-2)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return qnormalize(q)


def R2ypr(R: torch.Tensor) -> torch.Tensor:
    """Rotation → [yaw, pitch, roll] in DEGREES (utility.h:70-89)."""
    n = R[..., :, 0]
    o = R[..., :, 1]
    a = R[..., :, 2]
    y = torch.atan2(n[..., 1], n[..., 0])
    p = torch.atan2(-n[..., 2], n[..., 0] * torch.cos(y) + n[..., 1] * torch.sin(y))
    r = torch.atan2(a[..., 0] * torch.sin(y) - a[..., 1] * torch.cos(y),
                    -o[..., 0] * torch.sin(y) + o[..., 1] * torch.cos(y))
    return torch.stack([y, p, r], dim=-1) / math.pi * 180.0


def ypr2R(ypr: torch.Tensor) -> torch.Tensor:
    """[yaw, pitch, roll] DEGREES → rotation matrix (utility.h:91-112)."""
    y, p, r = (ypr / 180.0 * math.pi).unbind(-1)
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    zero = torch.zeros_like(y)
    one = torch.ones_like(y)
    Rz = torch.stack([torch.stack([cy, -sy, zero], -1),
                      torch.stack([sy, cy, zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    Ry = torch.stack([torch.stack([cp, zero, sp], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([-sp, zero, cp], -1)], -2)
    Rx = torch.stack([torch.stack([one, zero, zero], -1),
                      torch.stack([zero, cr, -sr], -1),
                      torch.stack([zero, sr, cr], -1)], -2)
    return Rz @ Ry @ Rx


def g2R(g: torch.Tensor) -> torch.Tensor:
    """Rotation taking gravity direction g to +z with zero yaw
    (utility.cpp): R0 @ (g/|g|) = [0,0,1] and yaw(R0) = 0."""
    ng1 = g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    ng2 = torch.eye(3, dtype=g.dtype, device=g.device)[2].expand_as(ng1)
    c = torch.sum(ng1 * ng2, dim=-1, keepdim=True)
    axis = torch.linalg.cross(ng1, ng2)
    R0 = q2R(qnormalize(torch.cat([1.0 + c, axis], dim=-1)))
    yaw = R2ypr(R0)[..., 0]
    zero = torch.zeros_like(yaw)
    return ypr2R(torch.stack([-yaw, zero, zero], dim=-1)) @ R0


def normalize_angle(deg: torch.Tensor) -> torch.Tensor:
    """Wrap angle in degrees to [-180, 180) (utility.h:134-143)."""
    return deg - 360.0 * torch.floor((deg + 180.0) / 360.0)


def pose_boxplus(p: torch.Tensor, q: torch.Tensor, dp: torch.Tensor,
                 dth: torch.Tensor):
    """SE(3)-style update used by the solver: p += dp, q ← q ⊗ δq(dθ)
    (factor/pose_local_parameterization.cpp:3-19)."""
    return p + dp, qnormalize(qmul(q, deltaQ(dth)))
