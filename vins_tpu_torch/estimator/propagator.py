"""IMU-rate state propagation for low-latency output.

A numpy copy of `vins_tpu/estimator/propagator.py` on the port's `nplie`.
Re-expression of the reference's `predict`/`update` pair in the estimator
node (vins_estimator/src/estimator_node.cpp:42-96): between optimized frames
the latest pose is midpoint-propagated at IMU rate (published as
`imu_propagate` for control loops); after every solve the propagator is
re-based onto the optimized state and the buffered IMU since the frame
timestamp is replayed.  Pure numpy — the math is ~30 flops per sample and
latency-critical, so no device round trip.
"""
from __future__ import annotations

import collections

import numpy as np

from ..core.nplie import qmul as _nq_mul
from ..core.nplie import qrotate as _nq_rot


def _quat_mul(a, b):
    return _nq_mul(a, b)


def _quat_rot(q, v):
    return _nq_rot(q, v)


def _delta_q(w_dt):
    return np.array([1.0, 0.5 * w_dt[0], 0.5 * w_dt[1], 0.5 * w_dt[2]])


def midpoint_propagate_batch(p, q, v, ba, bg, g, dt, acc, gyr):
    """Vectorized midpoint propagation over one interval's IMU samples.

    Exactly the per-sample recurrence of the reference (estimator.cpp:107-114
    / estimator_node.cpp:58-75: un_acc_0 with the pre-update attitude,
    un_acc_1 with the post-update one), with all per-sample vector work done
    in O(1) numpy passes; only the inherently sequential length-N quaternion
    chain stays a (cheap, 16-flop-per-step) Python loop.  Layout matches the
    per-interval buffers: dt [N]; acc/gyr [N+1, 3] with the interval's
    boundary sample at index 0.  Returns (p, q, v) after all N samples."""
    dt = np.asarray(dt, float)
    n = len(dt)
    if n == 0:
        return p, q, v
    acc = np.asarray(acc, float)
    gyr = np.asarray(gyr, float)
    un_gyr = 0.5 * (gyr[:-1] + gyr[1:]) - bg                   # [N,3]
    dq = np.concatenate([np.ones((n, 1)), 0.5 * un_gyr * dt[:, None]],
                        axis=1)                                # unnormalized
    qs = np.empty((n + 1, 4))
    qs[0] = q
    qk = np.asarray(q, float)
    for k in range(n):
        qk = _nq_mul(qk, dq[k])
        qk = qk / np.linalg.norm(qk)
        qs[k + 1] = qk
    a_w = _nq_rot(qs, acc - ba) - g                            # [N+1,3]
    un_acc = 0.5 * (a_w[:-1] + a_w[1:])                        # [N,3]
    dv = dt[:, None] * un_acc
    v_pre = v + np.concatenate([np.zeros((1, 3)), np.cumsum(dv[:-1], 0)]) \
        if n > 1 else v[None]
    p_new = p + np.sum(dt[:, None] * v_pre
                       + 0.5 * (dt ** 2)[:, None] * un_acc, axis=0)
    return p_new, qs[n], v + dv.sum(0)


class ImuPropagator:
    def __init__(self, g_norm: float = 9.81007, buf_len: int = 2000):
        self.g = np.array([0.0, 0.0, g_norm])
        self.buf = collections.deque(maxlen=buf_len)  # (t, acc, gyr)
        self.reset()

    def reset(self):
        self.t = None
        self.p = np.zeros(3)
        self.q = np.array([1.0, 0, 0, 0])
        self.v = np.zeros(3)
        self.ba = np.zeros(3)
        self.bg = np.zeros(3)
        self.acc_prev = np.zeros(3)
        self.gyr_prev = np.zeros(3)

    def predict(self, t: float, acc, gyr):
        """One IMU sample (estimator_node.cpp:42-78).  Returns (p, q, v)."""
        acc = np.asarray(acc, float)
        gyr = np.asarray(gyr, float)
        self.buf.append((t, acc, gyr))
        if self.t is None:
            self.t = t
            self.acc_prev, self.gyr_prev = acc, gyr
            return self.p, self.q, self.v
        dt = t - self.t
        self.t = t
        un_acc_0 = _quat_rot(self.q, self.acc_prev - self.ba) - self.g
        un_gyr = 0.5 * (self.gyr_prev + gyr) - self.bg
        self.q = _quat_mul(self.q, _delta_q(un_gyr * dt))
        self.q /= np.linalg.norm(self.q)
        un_acc_1 = _quat_rot(self.q, acc - self.ba) - self.g
        un_acc = 0.5 * (un_acc_0 + un_acc_1)
        self.p = self.p + dt * self.v + 0.5 * dt * dt * un_acc
        self.v = self.v + dt * un_acc
        self.acc_prev, self.gyr_prev = acc, gyr
        return self.p, self.q, self.v

    def rebase(self, t: float, p, q, v, ba, bg):
        """Re-sync onto an optimized state and replay buffered IMU newer than
        t (estimator_node.cpp:80-96 update())."""
        self.t = t
        self.p = np.asarray(p, float).copy()
        self.q = np.asarray(q, float).copy()
        self.v = np.asarray(v, float).copy()
        self.ba = np.asarray(ba, float).copy()
        self.bg = np.asarray(bg, float).copy()
        replay = [s for s in self.buf if s[0] > t]
        self.buf.clear()
        if replay:
            self.acc_prev, self.gyr_prev = replay[0][1], replay[0][2]
        for s in replay:
            self.predict(*s)
