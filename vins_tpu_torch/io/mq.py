"""Measurement queue: thread-safe IMU/feature alignment.

Counterpart of `vins_tpu/io/mq.py` (the reference's estimator_node buffer
machinery, vins_estimator/src/estimator_node.cpp: imu_buf/feature_buf and
a condition variable, `getMeasurements` :98-136, out-of-order IMU rejection
:138-146), in Python only: a producer thread pushes samples and frames, the
consumer blocks in `next` on a `threading.Condition`.

Alignment contract (shared with io/euroc.py::iter_measurements): for a frame
at t_img, deliver every IMU sample with t <= t_img + td; when the last real
sample lands strictly before t_img + td, append a row linearly interpolated
at exactly t_img + td (the straddling-sample split of
estimator_node.cpp:246-264) so every interval ends at the frame time.  The
final delivered row is retained as the next interval's opening boundary, so
consecutive intervals tile the timeline with no gap; frames older than the
whole IMU buffer are dropped.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np


class Aligned(NamedTuple):
    t_img: float
    payload: int
    imu_t: np.ndarray      # [n]
    imu_acc: np.ndarray    # [n,3]
    imu_gyr: np.ndarray    # [n,3]


class MeasurementQueue:
    def __init__(self, imu_cap: int = 1 << 20, feat_cap: int = 1 << 16):
        self._imu: list = []
        self._feat: list = []
        self._last_imu_t = -np.inf
        self._imu_cap, self._feat_cap = imu_cap, feat_cap
        self._closed = False
        self._first = True
        self._dropped = 0
        self._rejected = 0
        self._cv = threading.Condition()

    def push_imu(self, t, acc, gyr) -> bool:
        """Queue one sample; False if it is not newer than the last one
        (counted as rejected) or the queue is full."""
        with self._cv:
            if t <= self._last_imu_t or len(self._imu) >= self._imu_cap:
                self._rejected += t <= self._last_imu_t
                return False
            self._last_imu_t = t
            self._imu.append((float(t), np.asarray(acc, float).copy(),
                              np.asarray(gyr, float).copy()))
            self._cv.notify_all()
            return True

    def push_feature(self, t, payload: int = 0) -> bool:
        with self._cv:
            if len(self._feat) >= self._feat_cap:
                return False
            self._feat.append((float(t), int(payload)))
            self._cv.notify_all()
            return True

    def close(self):
        """No more input: `next` returns None once nothing can be aligned."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def restart(self):
        with self._cv:
            self._imu.clear()
            self._feat.clear()
            self._last_imu_t = -np.inf
            self._first = True
            self._closed = False
            self._cv.notify_all()

    def stats(self):
        with self._cv:
            return {"dropped_frames": self._dropped, "rejected_imu": self._rejected,
                    "imu_len": len(self._imu), "feat_len": len(self._feat)}

    def next(self, td: float = 0.0, blocking: bool = True):
        """The next aligned frame and its IMU interval; None when the queue
        is closed and nothing more aligns.  Non-blocking, it raises
        BlockingIOError when nothing is ready."""
        with self._cv:
            while True:
                if self._feat and self._imu:
                    t_f, payload = self._feat[0]
                    t_end = t_f + td
                    if self._imu[0][0] > t_end:
                        self._feat.pop(0)
                        if not self._first:
                            self._dropped += 1
                        continue
                    if self._imu[-1][0] > t_end:
                        n = 0
                        while n < len(self._imu) and self._imu[n][0] <= t_end:
                            n += 1
                        rows = list(self._imu[:n])
                        if rows[-1][0] < t_end:
                            # split the straddling sample: linear interp at
                            # exactly t_end (estimator_node.cpp:246-264)
                            t0, a0, g0 = self._imu[n - 1]
                            t1, a1, g1 = self._imu[n]
                            w = (t_end - t0) / (t1 - t0)
                            interp = (t_end, a0 + w * (a1 - a0), g0 + w * (g1 - g0))
                            rows.append(interp)
                            del self._imu[:n]
                            self._imu.insert(0, interp)
                        else:
                            del self._imu[:n - 1]
                        self._feat.pop(0)
                        self._first = False
                        self._cv.notify_all()
                        return Aligned(t_f, payload, np.asarray([r[0] for r in rows]),
                                       np.stack([r[1] for r in rows]),
                                       np.stack([r[2] for r in rows]))
                if self._closed:
                    return None
                if not blocking:
                    raise BlockingIOError("no aligned measurement ready")
                self._cv.wait()
