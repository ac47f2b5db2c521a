"""Numpy twins of core/lie.py for HOST-SIDE bookkeeping.

A copy of `vins_tpu/core/nplie.py`.  The estimator's host state machine
manipulates single quaternions and 3-vectors at IMU/keyframe rate, where a
device op per quaternion would cost a launch (and a sync to read it back)
each.  Same math as core/lie.py (utility.h parity), same [w,x,y,z]
convention; everything accepts trailing-axis batches.
"""
from __future__ import annotations

import numpy as np


def qmul(q1, q2):
    w1, x1, y1, z1 = np.moveaxis(np.asarray(q1, float), -1, 0)
    w2, x2, y2, z2 = np.moveaxis(np.asarray(q2, float), -1, 0)
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def qconj(q):
    return np.asarray(q, float) * np.array([1.0, -1.0, -1.0, -1.0])


def qnormalize(q):
    q = np.asarray(q, float)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def qrotate(q, v):
    q = np.asarray(q, float)
    v = np.asarray(v, float)
    w = q[..., :1]
    u = q[..., 1:]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def deltaQ(dtheta):
    half = 0.5 * np.asarray(dtheta, float)
    one = np.ones_like(half[..., :1])
    return qnormalize(np.concatenate([one, half], axis=-1))


def q2R(q):
    w, x, y, z = np.moveaxis(qnormalize(q), -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return np.stack([
        np.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
        np.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
        np.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
    ], axis=-2)


def R2q(R):
    """Rotation matrix [...,3,3] → quaternion (w ≥ 0), Shepperd selection.
    Batched over leading axes."""
    R = np.asarray(R, float)
    if R.ndim > 2:
        return _R2q_batch(R)
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (m21 - m12) / s, (m02 - m20) / s,
                      (m10 - m01) / s])
    elif m00 >= m11 and m00 >= m22:
        s = np.sqrt(1.0 + m00 - m11 - m22) * 2
        q = np.array([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s,
                      (m02 + m20) / s])
    elif m11 >= m22:
        s = np.sqrt(1.0 + m11 - m00 - m22) * 2
        q = np.array([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s,
                      (m12 + m21) / s])
    else:
        s = np.sqrt(1.0 + m22 - m00 - m11) * 2
        q = np.array([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s,
                      0.25 * s])
    if q[0] < 0:
        q = -q
    return qnormalize(q)


def normalize_angle(deg):
    """Wrap degrees to [-180, 180) (utility.h:134-143; the floor-based
    formula maps +180 to -180)."""
    deg = np.asarray(deg, float)
    return deg - 360.0 * np.floor((deg + 180.0) / 360.0)


def _R2q_batch(R):
    """Vectorized Shepperd over leading batch axes."""
    m = R.reshape(-1, 3, 3)
    m00, m11, m22 = m[:, 0, 0], m[:, 1, 1], m[:, 2, 2]
    tr = m00 + m11 + m22
    # four candidate constructions; pick per-element the numerically best
    qs = np.zeros((4, len(m), 4))
    s0 = np.sqrt(np.maximum(tr + 1.0, 1e-12)) * 2
    qs[0] = np.stack([0.25 * s0, (m[:, 2, 1] - m[:, 1, 2]) / s0,
                      (m[:, 0, 2] - m[:, 2, 0]) / s0,
                      (m[:, 1, 0] - m[:, 0, 1]) / s0], axis=-1)
    s1 = np.sqrt(np.maximum(1.0 + m00 - m11 - m22, 1e-12)) * 2
    qs[1] = np.stack([(m[:, 2, 1] - m[:, 1, 2]) / s1, 0.25 * s1,
                      (m[:, 0, 1] + m[:, 1, 0]) / s1,
                      (m[:, 0, 2] + m[:, 2, 0]) / s1], axis=-1)
    s2 = np.sqrt(np.maximum(1.0 + m11 - m00 - m22, 1e-12)) * 2
    qs[2] = np.stack([(m[:, 0, 2] - m[:, 2, 0]) / s2,
                      (m[:, 0, 1] + m[:, 1, 0]) / s2, 0.25 * s2,
                      (m[:, 1, 2] + m[:, 2, 1]) / s2], axis=-1)
    s3 = np.sqrt(np.maximum(1.0 + m22 - m00 - m11, 1e-12)) * 2
    qs[3] = np.stack([(m[:, 1, 0] - m[:, 0, 1]) / s3,
                      (m[:, 0, 2] + m[:, 2, 0]) / s3,
                      (m[:, 1, 2] + m[:, 2, 1]) / s3, 0.25 * s3], axis=-1)
    case = np.where(
        tr > 0, 0,
        np.where((m00 >= m11) & (m00 >= m22), 1, np.where(m11 >= m22, 2, 3)),
    )
    q = qs[case, np.arange(len(m))]
    q = np.where(q[:, :1] < 0, -q, q)
    return qnormalize(q).reshape(R.shape[:-2] + (4,))


def R2ypr(R):
    """Rotation → [yaw, pitch, roll] in DEGREES (utility.h:70-89)."""
    R = np.asarray(R, float)
    n, o, a = R[..., :, 0], R[..., :, 1], R[..., :, 2]
    y = np.arctan2(n[..., 1], n[..., 0])
    p = np.arctan2(-n[..., 2], n[..., 0] * np.cos(y) + n[..., 1] * np.sin(y))
    r = np.arctan2(
        a[..., 0] * np.sin(y) - a[..., 1] * np.cos(y),
        -o[..., 0] * np.sin(y) + o[..., 1] * np.cos(y),
    )
    return np.stack([y, p, r], axis=-1) / np.pi * 180.0


def ypr2R(ypr):
    """[..., yaw, pitch, roll] DEGREES → rotation matrix (utility.h:91-112).
    Batched over leading axes."""
    y, p, r = np.moveaxis(np.asarray(ypr, float) / 180.0 * np.pi, -1, 0)
    cy, sy = np.cos(y), np.sin(y)
    cp, sp = np.cos(p), np.sin(p)
    cr, sr = np.cos(r), np.sin(r)
    z, o = np.zeros_like(cy), np.ones_like(cy)
    Rz = np.stack([np.stack([cy, -sy, z], -1), np.stack([sy, cy, z], -1),
                   np.stack([z, z, o], -1)], -2)
    Ry = np.stack([np.stack([cp, z, sp], -1), np.stack([z, o, z], -1),
                   np.stack([-sp, z, cp], -1)], -2)
    Rx = np.stack([np.stack([o, z, z], -1), np.stack([z, cr, -sr], -1),
                   np.stack([z, sr, cr], -1)], -2)
    return Rz @ Ry @ Rx
