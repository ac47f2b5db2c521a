"""Fixed-slot sliding-window feature database (host side).

A numpy copy of `vins_tpu/estimator/feature_db.py` whose solver view is the
port's `FeatureObs`.  It replaces the reference's `FeatureManager`
linked-list bookkeeping (vins_estimator/src/feature_manager.{h,cpp}:
list<FeaturePerId> with dynamic per-feature observation vectors) with dense
[L, F] numpy arrays + masks.  All mutations here are tiny O(L·F) host ops;
the arrays are consumed directly as the solver's `FeatureObs` view.  Depth lives in *inverse depth* anchored at
the first observing frame, like the reference.
"""
from __future__ import annotations

import numpy as np

from ..solver.problem import FeatureObs


class FeatureDB:
    def __init__(self, max_landmarks: int, frames: int):
        L, F = max_landmarks, frames
        self.L, self.F = L, F
        self.ids = np.full(L, -1, np.int64)  # -1 = free slot
        self.pt = np.zeros((L, F, 2))
        self.vel = np.zeros((L, F, 2))
        self.uv = np.zeros((L, F, 2))  # raw pixels (kept for loop closure)
        self.toff = np.zeros((L, F))
        self.valid = np.zeros((L, F), bool)
        self.inv_depth = np.full(L, -1.0)  # <0 ⇒ not yet triangulated
        self.n_dropped = 0  # slots lost to capacity (observability metric)

    # -- queries ----------------------------------------------------------

    @property
    def used(self) -> np.ndarray:
        return self.ids >= 0

    @property
    def anchor(self) -> np.ndarray:
        """First observing frame per slot (0 for free slots)."""
        return np.argmax(self.valid, axis=1).astype(np.int32)

    def active_mask(self) -> np.ndarray:
        """Solver eligibility (feature_manager.cpp: used_num ≥ 2 &&
        start_frame < WINDOW_SIZE − 2)."""
        nobs = self.valid.sum(1)
        return self.used & (nobs >= 2) & (self.anchor < self.F - 2)

    def count_tracked(self, frame: int, min_obs: int = 2) -> int:
        """Features observed in `frame` with ≥min_obs observations
        (the reference's last_track_num uses track length ≥ 2)."""
        return int((self.valid[:, frame] & (self.valid.sum(1) >= min_obs)).sum())

    # -- per-frame update --------------------------------------------------

    def add_frame(self, ids, pts, vels, uvs, toffs, frame: int) -> bool:
        """Insert the newest frame's observations at column `frame`; returns
        the keyframe decision (True = marginalize old) exactly as
        addFeatureCheckParallax (feature_manager.cpp:45-97)."""
        ids = np.asarray(ids, np.int64)
        last_track_num = 0
        slot_of = {int(i): k for k, i in enumerate(self.ids) if i >= 0}
        for n, fid in enumerate(ids):
            fid = int(fid)
            k = slot_of.get(fid)
            if k is None:
                free = np.nonzero(self.ids < 0)[0]
                if len(free) == 0:
                    self.n_dropped += 1
                    continue
                k = int(free[0])
                self.ids[k] = fid
                slot_of[fid] = k
            else:
                last_track_num += 1
            self.pt[k, frame] = pts[n]
            self.vel[k, frame] = vels[n]
            self.uv[k, frame] = uvs[n]
            self.toff[k, frame] = toffs[n] if np.ndim(toffs) else toffs
            self.valid[k, frame] = True

        if frame < 2 or last_track_num < 20:
            return True
        # mean parallax of features spanning frames (frame-2, frame-1)
        span = self.used & self.valid[:, frame - 2] & self.valid[:, frame - 1]
        # (compensatedParallax2: both the raw and "compensated" du/dv are on
        # the z=1 plane here, so they coincide — plain norm)
        if span.sum() == 0:
            return True
        d = self.pt[span, frame - 2] - self.pt[span, frame - 1]
        parallax = np.linalg.norm(d, axis=1).mean()
        return bool(parallax >= self._min_parallax)

    _min_parallax = 10.0 / 460.0  # set by Estimator from config

    # -- sliding -----------------------------------------------------------

    def slide_old(self, p_cam0, R_cam0, p_cam1, R_cam1):
        """Marginalize the oldest frame (removeBackShiftDepth,
        feature_manager.cpp:275-313): shift observation columns left and
        transfer anchored depths from camera 0 to camera 1 using the
        *pre-slide, post-solve* camera poses."""
        anchored0 = self.used & self.valid[:, 0]
        # re-anchor depth: X_c1 = R1ᵀ(R0·(pt0·d) + p0 − p1)
        for k in np.nonzero(anchored0)[0]:
            rest = self.valid[k, 1:].sum()
            if rest < 2:
                # reference erases anchored features left with <2 obs
                # (feature_manager.cpp:286-289)
                self._free(k)
                continue
            if self.inv_depth[k] > 0:
                d = 1.0 / self.inv_depth[k]
                Xc0 = np.append(self.pt[k, 0], 1.0) * d
                Xw = R_cam0 @ Xc0 + p_cam0
                Xc1 = R_cam1.T @ (Xw - p_cam1)
                z = Xc1[2]
                self.inv_depth[k] = 1.0 / z if z > 0.1 else 1.0 / 5.0
        # shift columns left
        for a in (self.pt, self.vel, self.uv, self.toff, self.valid):
            a[:, :-1] = a[:, 1:]
            a[:, -1] = 0
        # drop now-empty slots
        for k in np.nonzero(self.used & (self.valid.sum(1) == 0))[0]:
            self._free(k)

    def slide_new(self):
        """Marginalize the second-newest frame (removeFront,
        feature_manager.cpp:333-353): its observations vanish, the newest
        frame's move into its slot."""
        F = self.F
        both = self.valid[:, F - 1]
        for a in (self.pt, self.vel, self.uv):
            a[:, F - 2] = np.where(both[:, None], a[:, F - 1], 0.0)
        self.toff[:, F - 2] = np.where(both, self.toff[:, F - 1], 0.0)
        self.valid[:, F - 2] = both
        self.valid[:, F - 1] = False
        self.pt[:, F - 1] = 0
        self.vel[:, F - 1] = 0
        self.uv[:, F - 1] = 0
        self.toff[:, F - 1] = 0
        for k in np.nonzero(self.used & (self.valid.sum(1) == 0))[0]:
            self._free(k)

    def remove_failures(self, solved_inv_depth: np.ndarray):
        """Adopt solved depths; drop features that solved to negative depth
        (solve_flag == 2, feature_manager.cpp:161-170)."""
        act = self.active_mask()
        bad = act & (solved_inv_depth <= 0)
        self.inv_depth[act] = solved_inv_depth[act]
        for k in np.nonzero(bad)[0]:
            self._free(k)

    def _free(self, k: int):
        self.ids[k] = -1
        self.valid[k] = False
        self.pt[k] = 0
        self.vel[k] = 0
        self.uv[k] = 0
        self.toff[k] = 0
        self.inv_depth[k] = -1.0

    def clear(self):
        for k in range(self.L):
            self._free(k)
        self.n_dropped = 0

    # -- solver view -------------------------------------------------------

    def to_obs(self, dtype) -> FeatureObs:
        """The solver's view, as numpy leaves of `dtype`."""
        return FeatureObs(
            pt=np.asarray(self.pt, dtype),
            vel=np.asarray(self.vel, dtype),
            toff=np.asarray(self.toff, dtype),
            valid=self.valid,
            anchor=self.anchor,
            inv_depth=np.asarray(self.inv_depth, dtype),
            active=self.active_mask(),
        )
