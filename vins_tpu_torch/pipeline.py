"""Full-system pipeline: front-end → estimator (serial mode, no loop closure).

PyTorch counterpart of the serial path of `vins_tpu/pipeline.py`, the
reference's roslaunch graph (vins_estimator/launch/euroc.launch) as direct
calls:

  * frequency controller: track every frame, publish features at FREQ Hz
    (feature_tracker_node.cpp:51-62),
  * stream-health watchdog: >1 s gap or backwards time ⇒ restart both the
    tracker and the estimator (feature_tracker_node.cpp:38-48,
    estimator_node.cpp:179-198),
  * IMU-rate propagation output (estimator_node.cpp:42-96).

Loop closure (the pose graph) and the overlapped mode are not ported yet:
asking for either raises NotImplementedError.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import VinsConfig
from .estimator.estimator import NON_LINEAR, Estimator
from .estimator.propagator import ImuPropagator
from .frontend.tracker import FeatureTracker
from .utils.trace import Tracer


def circular_fov_mask(h: int, w: int, margin: int = 4) -> np.ndarray:
    """Circular field-of-view mask for fisheye lenses — the built-in analog
    of the reference's fisheye_mask.jpg (feature_tracker_node.cpp:216-229):
    True inside the image circle."""
    yy, xx = np.mgrid[:h, :w]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    r = min(h, w) / 2.0 - margin
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


class Pipeline:
    def __init__(self, cfg: VinsConfig, camera, imu_buf_len: int = 256,
                 loop_closure: bool | None = None, dtype=torch.float64,
                 overlap: bool | None = None, device="cuda"):
        self.cfg = cfg
        self.camera = camera
        self.device = torch.device(device)
        self.loop_closure = cfg.loop_closure if loop_closure is None else loop_closure
        if self.loop_closure:
            raise NotImplementedError(
                "loop closure is not ported yet (ROADMAP Queue 1 item 9): "
                "pass loop_closure=False")
        self.overlap = bool(cfg.overlap) if overlap is None else bool(overlap)
        if self.overlap:
            raise NotImplementedError(
                "the overlapped pipeline is not ported yet (ROADMAP Queue 1 item 8, "
                "overlap mode): pass overlap=False")
        mask = circular_fov_mask(cfg.image_height, cfg.image_width) if cfg.fisheye else None
        self.tracker = FeatureTracker(
            camera, max_cnt=cfg.max_cnt, min_dist=cfg.min_dist, f_threshold=cfg.f_threshold,
            equalize=cfg.equalize, focal=cfg.focal, mask=mask, device=self.device)
        self.estimator = Estimator(cfg, imu_buf_len=imu_buf_len, dtype=dtype, device=self.device)
        self.propagator = ImuPropagator(cfg.g_norm)

        self.freq = cfg.freq
        self._pub_count = 0
        self._first_image_time = None
        self._last_image_time = None
        self.trajectory = []  # (t, p, q) VIO outputs
        # per-stage wall-clock stats (the reference's TicToc/printStatistics);
        # on CUDA every span waits for the device before it stops
        self.tracer = Tracer(sync=torch.cuda.synchronize if self.device.type == "cuda" else None)

    # ------------------------------------------------------------------ IMU

    def process_imu(self, t: float, acc, gyr):
        dt = t - self.propagator.t if self.propagator.t is not None else 0.0
        self.estimator.process_imu(dt, acc, gyr)
        return self.propagator.predict(t, acc, gyr)

    # ---------------------------------------------------------------- image

    def process_image(self, img, t: float, gumbel=None) -> dict:
        """One camera frame ([H,W] numpy array or tensor).  `gumbel`
        replaces the tracker's own RANSAC draw on a published frame."""
        # stream-health watchdog (feature_tracker_node.cpp:38-48)
        if self._last_image_time is not None and (
                t - self._last_image_time > 1.0 or t < self._last_image_time):
            self._restart()
        self._last_image_time = t
        if self._first_image_time is None:
            self._first_image_time = t

        # frequency controller (feature_tracker_node.cpp:51-62)
        elapsed = max(t - self._first_image_time, 1e-9)
        publish = self._pub_count / elapsed <= self.freq or self.freq <= 0
        if publish and abs(self._pub_count / elapsed - self.freq) < 0.01 * self.freq:
            self._first_image_time = t
            self._pub_count = 0

        with self.tracer.span("frontend"):
            feats = self.tracker.read_image(img, t, publish=publish, gumbel=gumbel)
        out = {"published": publish}
        if not publish or feats is None:
            return out
        self._pub_count += 1
        out.update(self._estimator_and_downstream(feats, t))
        return out

    def _estimator_and_downstream(self, feats, t: float) -> dict:
        with self.tracer.span("estimator"):
            ev = self.estimator.process_image(feats.ids, feats.pts, feats.vel, feats.uv, t,
                                              toffs=self._toffs(feats))
        out = dict(ev)
        self._downstream(out, t)
        return out

    def _toffs(self, feats):
        """Rolling-shutter per-observation time offset: a feature on pixel
        row r was captured TR·(r/ROW − ½) after the nominal frame time
        (projection_td_factor.cpp:18,50-52); the solver's correction is
        pt − (td − toff)·vel, so toff = −offset."""
        if self.cfg.rolling_shutter and self.cfg.rolling_shutter_tr > 0:
            return -self.cfg.rolling_shutter_tr * (
                np.asarray(feats.uv)[:, 1] / self.cfg.image_height - 0.5)
        return 0.0

    def _downstream(self, out: dict, t: float):
        """Post-solve host work of one published frame: the trajectory and
        the IMU-rate predictor rebase."""
        est = self.estimator
        if est.solver_flag == NON_LINEAR:
            W = est.W
            p, q = est.p[W].copy(), est.q[W].copy()
            self.trajectory.append((t, p, q))
            self.propagator.rebase(t, p, q, est.v[W], est.ba[W], est.bg[W])

    # ---------------------------------------------------------------- admin

    def _restart(self):
        """Stream fault: reboot the front-end and the estimator (the
        reference's restart topic)."""
        self.tracker.reset()
        self.estimator.clear_state()
        self.propagator.reset()
        self._first_image_time = None
        self._pub_count = 0
