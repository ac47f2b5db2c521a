"""Full-system pipeline: front-end → estimator (loop closure off).

PyTorch counterpart of `vins_tpu/pipeline.py` without the pose graph, the
reference's roslaunch graph (vins_estimator/launch/euroc.launch) as direct
calls:

  * frequency controller: track every frame, publish features at FREQ Hz
    (feature_tracker_node.cpp:51-62),
  * stream-health watchdog: >1 s gap or backwards time ⇒ restart both the
    tracker and the estimator (feature_tracker_node.cpp:38-48,
    estimator_node.cpp:179-198),
  * IMU-rate propagation output (estimator_node.cpp:42-96).

Two modes, with the same estimator inputs in the same order and so the same
trajectory: serial, where each published frame's front-end result is
fetched and its estimator step completed before `process_image` returns,
and overlapped (`overlap=True`), where the estimator runs one published
frame behind the front-end (see `_process_image_overlapped`).  Loop closure
(the pose graph) is not ported yet: asking for it raises
NotImplementedError.
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
                 overlap: bool | None = None, device="cuda", cuda_graph: bool = True):
        self.cfg = cfg
        self.camera = camera
        self.device = torch.device(device)
        self.loop_closure = cfg.loop_closure if loop_closure is None else loop_closure
        if self.loop_closure:
            raise NotImplementedError(
                "loop closure is not ported yet (ROADMAP Queue 1 item 9): "
                "pass loop_closure=False")
        self.overlap = bool(cfg.overlap) if overlap is None else bool(overlap)
        mask = circular_fov_mask(cfg.image_height, cfg.image_width) if cfg.fisheye else None
        self.tracker = FeatureTracker(
            camera, max_cnt=cfg.max_cnt, min_dist=cfg.min_dist, f_threshold=cfg.f_threshold,
            equalize=cfg.equalize, focal=cfg.focal, mask=mask, device=self.device)
        self.estimator = Estimator(cfg, imu_buf_len=imu_buf_len, dtype=dtype, device=self.device,
                                   cuda_graph=cuda_graph)
        self.propagator = ImuPropagator(cfg.g_norm)

        # Overlapped mode: the estimator consumes the PREVIOUS published
        # frame's features while the current frame's front-end runs on the
        # device (the reference runs the tracker and the estimator as
        # separate processes).  Per published frame:
        #   1. complete the estimator step dispatched last call (its result
        #      copy has usually landed by now),
        #   2. fetch the pending front blob (its copy was started last call)
        #      and dispatch its estimator step, before the new front step so
        #      that its result copy does not queue behind it,
        #   3. dispatch the current frame's front step and start its copy.
        self._pending = None      # (t, front blob handle) not yet consumed
        self._imu_backlog = []    # (t, dt, acc, gyr) since the pending frame
        self._est_pending = None  # (PendingStep, t) dispatched, not completed
        self.sequence = 1

        self.freq = cfg.freq
        self._pub_count = 0
        self._first_image_time = None
        self._last_image_time = None
        self.trajectory = []  # (t, p, q) VIO outputs
        # per-stage wall-clock stats (the reference's TicToc/printStatistics);
        # serial on CUDA, every span waits for the device before it stops;
        # overlapped, spans time the host (a wait would undo the overlap),
        # and "front_fetch" and "est_fetch" show where it blocks
        sync = self.device.type == "cuda" and not self.overlap
        self.tracer = Tracer(sync=torch.cuda.synchronize if sync else None)

    # ------------------------------------------------------------------ IMU

    def process_imu(self, t: float, acc, gyr):
        dt = t - self.propagator.t if self.propagator.t is not None else 0.0
        if self.overlap:
            # the estimator's input runs one published frame late; the
            # IMU-rate output (propagator) stays real-time
            self._imu_backlog.append((t, dt, acc, gyr))
        else:
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

        if self.overlap:
            return self._process_image_overlapped(img, t, publish, gumbel)

        with self.tracer.span("frontend"):
            feats = self.tracker.read_image(img, t, publish=publish, gumbel=gumbel)
        out = {"published": publish}
        if not publish or feats is None:
            return out
        self._pub_count += 1
        out.update(self._estimator_and_downstream(feats, t))
        return out

    def _process_image_overlapped(self, img, t: float, publish: bool, gumbel) -> dict:
        """Overlapped frame path (see __init__): consume the pending front
        frame through the estimator first, then dispatch this frame's front
        step.  The events returned are those of earlier frames."""
        out = {"published": publish}
        out.update(self._consume_pending())
        with self.tracer.span("frontend"):
            blob = self.tracker.read_image_device(img, t, publish=publish, gumbel=gumbel)
        if publish:
            self._pub_count += 1
            self._pending = (t, blob)
        return out

    def _consume_pending(self) -> dict:
        # complete the step dispatched last call: its post_step slides the
        # window before this frame's pre_step
        out = self._complete_est()
        if self._pending is None:
            # the backlog belongs to the next published frame's interval
            return out
        t_prev, blob = self._pending
        self._pending = None
        # samples up to the pending frame close its interval; later ones
        # wait for the next published frame
        before = [s for s in self._imu_backlog if s[0] <= t_prev + 1e-12]
        self._imu_backlog = [s for s in self._imu_backlog if s[0] > t_prev + 1e-12]
        for _, dt, acc, gyr in before:
            self.estimator.process_imu(dt, acc, gyr)
        with self.tracer.span("front_fetch"):
            feats = self.tracker.adopt_blob(blob)
        est = self.estimator
        if est.solver_flag == NON_LINEAR:
            with self.tracer.span("estimator"):
                pending = est.dispatch_step(feats.ids, feats.pts, feats.vel, feats.uv, t_prev,
                                            toffs=self._toffs(feats))
            self._est_pending = (pending, t_prev)
        else:
            # INITIAL: the synchronous per-frame path
            out = {**out, **self._estimator_and_downstream(feats, t_prev)}
        return out

    def _complete_est(self) -> dict:
        if self._est_pending is None:
            return {}
        pending, t = self._est_pending
        self._est_pending = None
        est = self.estimator
        with self.tracer.span("est_fetch"):
            res = est.fetch(pending)
        ev = est.post_step(res, pending.marg_old, failure_check=True)
        ev["kind"] = "vio" if ev.get("ok", True) else "reboot"
        self._downstream(ev, t)
        return ev

    def flush_frames(self) -> list:
        """Overlapped mode: run the pending frame through the estimator and
        complete its step (end of stream, before scoring trajectories).
        Returns the events this produces."""
        if not self.overlap:
            return []
        return [ev for ev in (self._consume_pending(), self._complete_est()) if ev]

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

    def pg_join(self):
        """End of stream.  With no pose graph this only drains the
        overlapped mode's pending frame."""
        self.flush_frames()

    def shutdown(self):
        """Stop the pose-graph worker: there is none without loop closure."""

    def _restart(self):
        """Stream fault: reboot the front-end and the estimator, drop the
        overlapped mode's pending work and open a new sequence (the
        reference's restart topic)."""
        self.tracker.reset()
        self.estimator.clear_state()
        self.propagator.reset()
        self._first_image_time = None
        self._pub_count = 0
        self._pending = None
        self._est_pending = None
        self._imu_backlog.clear()
        self.sequence += 1

    def write_trajectories(self, path_vio: str):
        """The VIO trajectory in TUM format."""
        from .io.euroc import write_tum

        if self.trajectory:
            t, p, q = zip(*self.trajectory)
            write_tum(path_vio, np.asarray(t), np.stack(p), np.stack(q))
