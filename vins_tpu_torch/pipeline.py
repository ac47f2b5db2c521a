"""Full-system pipeline: front-end → estimator → pose graph.

PyTorch counterpart of `vins_tpu/pipeline.py`, the reference's roslaunch
graph (vins_estimator/launch/euroc.launch wiring feature_tracker,
vins_estimator and pose_graph over topics) as direct calls:

  * frequency controller: track every frame, publish features at FREQ Hz
    (feature_tracker_node.cpp:51-62),
  * stream-health watchdog: >1 s gap or backwards time ⇒ restart both the
    tracker and the estimator (feature_tracker_node.cpp:38-48,
    estimator_node.cpp:179-198), and a new pose-graph sequence
    (pose_graph_node.cpp:69-91),
  * keyframe hand-off: when the estimator marginalizes a keyframe, its pose,
    its landmarks and the raw image build a pose-graph `KeyFrame`
    (visualization.cpp:348-404 pubKeyframe → pose_graph_node process()),
    in line or on a worker thread (`pg_async`),
  * fast relocalization: a verified loop's matches go back into the next
    window solve, whose refined loop edge updates the pose graph
    (estimator_node.cpp:266-291, pose_graph.cpp:889-923),
  * IMU-rate propagation output (estimator_node.cpp:42-96),
  * the textual report (`print_statistics`) and the debug images: the
    track overlay and, with `cfg.debug_image`, the loop-match image of
    every verified loop (`last_loop_image`, as in the JAX package, and
    each image to `loop_image_sink` when a caller sets one).

Two modes, with the same estimator inputs in the same order and so the same
trajectory: serial, where each published frame's front-end result is
fetched and its estimator step completed before `process_image` returns,
and overlapped (`overlap=True`), where the estimator runs one published
frame behind the front-end (see `_process_image_overlapped`).
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from .config import VinsConfig
from .core import nplie
from .estimator.estimator import NON_LINEAR, Estimator
from .estimator.propagator import ImuPropagator
from .frontend.tracker import FeatureTracker
from .loop.pose_graph import KeyFrame, PoseGraph, _upload
from .loop.verify import keyframe_features
from .utils.trace import Tracer

N_FAST = 256  # FAST corners per keyframe (vins_tpu/pipeline.py:96)


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
                 overlap: bool | None = None, device="cuda", cuda_graph: bool = True,
                 gumbel=None):
        """`gumbel(shape)` replaces the pose graph's own RANSAC draws (see
        `PoseGraph`)."""
        self.cfg = cfg
        self.camera = camera
        self.device = torch.device(device)
        self.loop_closure = cfg.loop_closure if loop_closure is None else loop_closure
        self.overlap = bool(cfg.overlap) if overlap is None else bool(overlap)
        mask = circular_fov_mask(cfg.image_height, cfg.image_width) if cfg.fisheye else None
        self.tracker = FeatureTracker(
            camera, max_cnt=cfg.max_cnt, min_dist=cfg.min_dist, f_threshold=cfg.f_threshold,
            equalize=cfg.equalize, focal=cfg.focal, mask=mask, device=self.device)
        self.estimator = Estimator(cfg, imu_buf_len=imu_buf_len, dtype=dtype, device=self.device,
                                   cuda_graph=cuda_graph)
        self.pose_graph = (
            PoseGraph(self.estimator.qic, self.estimator.tic, min_loop_inliers=cfg.min_loop_num,
                      opt_interval_s=cfg.pg_opt_interval, device=self.device, gumbel=gumbel)
            if self.loop_closure else None)
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
        self.trajectory_loop = []  # (t, p, q) pose-graph-corrected outputs
        # per-stage wall-clock stats (the reference's TicToc/printStatistics);
        # serial on CUDA, every span waits for the device before it stops;
        # overlapped, spans time the host (a wait would undo the overlap),
        # and "front_fetch" and "est_fetch" show where it blocks
        sync = self.device.type == "cuda" and not self.overlap
        self.tracer = Tracer(sync=torch.cuda.synchronize if sync else None)

        # the keyframe hand-off describes frame F-3, whose image arrived two
        # published frames earlier: a ring of recent published frames keyed
        # by time.  It keeps references: no caller or front step writes into
        # a frame it has handed in (the front step copies host frames, the
        # PNG decoder returns a new array per frame)
        self._img_ring: list = []
        # pose-graph ingestion gates (pose_graph_node.cpp:24,344-359,385)
        self._pg_skip_first = 0
        self._pg_skip_count = 0
        self._pg_last_t = np.array([-100.0, -100.0, -100.0])
        self._prev_kf_fast = None  # the previous keyframe's FAST set and camera pose
        self._relo_kf_index = None  # pose-graph keyframe of the armed relo match

        # asynchronous pose-graph worker (the reference's separate pose_graph
        # process, pose_graph_node.cpp:294-428: the frame loop never waits on
        # loop detection or the 4-DoF solve); sync mode keeps a deterministic
        # order.  The worker shares the default CUDA stream with the frame
        # loop.  Its spans go to a tracer of their own that never waits for
        # the device: a wait there would also wait for the frame loop's work.
        # The VIO step's graphs are captured on the estimator's first step,
        # before any keyframe reaches the worker, and never again (a restart
        # keeps them), so the worker never runs CUDA work during a capture.
        self.pg_async = bool(cfg.pg_async) and self.pose_graph is not None
        self.pg_tracer = Tracer() if self.pg_async else self.tracer
        self.pg_events: list = []    # pose-graph results, in order
        self.last_loop_image = None  # the newest loop-match image (cfg.debug_image)
        # called as sink(keyframe index, image) with every loop-match image,
        # on the thread that draws it (the worker with pg_async)
        self.loop_image_sink = None
        self.pg_dropped = 0          # keyframes dropped under backpressure
        self._relo_queue: list = []  # worker → frame loop fast-relocalization matches
        if self.pg_async:
            self._pg_queue: queue.Queue = queue.Queue(maxsize=4)
            self._pg_thread = threading.Thread(target=self._pg_worker, name="pose_graph",
                                               daemon=True)
            self._pg_thread.start()

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
        self._ring_append(t, img)
        out.update(self._estimator_and_downstream(feats, t))
        return out

    def _ring_append(self, t: float, img):
        self._img_ring.append((t, img))
        if len(self._img_ring) > 8:
            self._img_ring.pop(0)

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
            self._ring_append(t, img)
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

    def _downstream(self, out: dict, t: float, rebase: bool = True):
        """Post-solve host work of one published frame: the fast-relocalization
        feedback, the trajectories, the IMU-rate predictor rebase (unless
        `rebase` is False: `parallel.MultiPipeline` keeps the propagator's
        clock at the last IMU sample) and the keyframe hand-off.  Mutates
        `out` (sync mode adds the loop diagnostics)."""
        est = self.estimator
        pg = self.pose_graph
        if pg is not None:
            self._maybe_relo_feedback(out)
        if est.solver_flag != NON_LINEAR:
            return
        W = est.W
        p, q = est.p[W].copy(), est.q[W].copy()
        self.trajectory.append((t, p, q))
        if rebase:
            self.propagator.rebase(t, p, q, est.v[W], est.ba[W], est.bg[W])
        if pg is None:
            return
        pc, qc = pg.correct_pose(p, q, self.sequence)
        self.trajectory_loop.append((t, pc, qc))
        # the worker's fast-relocalization matches (the reference's relo_buf,
        # estimator_node.cpp:266-291)
        while self._relo_queue:
            self._apply_relo(self._relo_queue.pop(0))
        if not out.get("marg_old"):
            return
        payload = self._build_keyframe_payload()
        if payload is None:
            return
        if self.pg_async:
            try:
                self._pg_queue.put_nowait(payload)
            except queue.Full:
                # backpressure: drop rather than stall the frame loop (a
                # dropped keyframe only coarsens loop recall)
                self.pg_dropped += 1
            return
        with self.pg_tracer.span("pose_graph"):
            res = self._pg_process(payload)
        self.pg_events.append(res)
        for key in ("scores", "candidate", "verify"):
            if key in res:
                out[key] = res[key]
        if res.get("loop") is not None:
            out["loop"] = res["loop"]

    # ------------------------------------------------------------ pose graph

    def _pg_worker(self):
        while True:
            payload = self._pg_queue.get()
            try:
                if payload is None:
                    return
                with self.pg_tracer.span("pose_graph"):
                    res = self._pg_process(payload)
                self.pg_events.append(res)
            except Exception as e:  # noqa: BLE001 — the worker must not die
                self.pg_events.append({"error": repr(e)})
            finally:
                self._pg_queue.task_done()

    def _world_points(self, ks: np.ndarray) -> np.ndarray:
        """World positions of the landmarks in slots `ks` from their anchor
        frames' poses, inverse depths and the extrinsics."""
        est, db = self.estimator, self.estimator.db
        Rw = nplie.q2R(est.q)  # [F,3,3]: only F distinct anchor rotations
        Ric = nplie.q2R(est.qic)
        a = db.anchor[ks]
        rays = np.concatenate([db.pt[ks, a], np.ones((len(ks), 1))], axis=1) \
            / db.inv_depth[ks][:, None]
        Xc = rays @ Ric.T + est.tic
        return np.einsum("kij,kj->ki", Rw[a], Xc) + est.p[a]

    def _build_keyframe_payload(self):
        """The frame loop's half of the keyframe hand-off (pubKeyframe,
        visualization.cpp:348-404): the ingestion gates (pose_graph_node.cpp:
        24,344-359,385: skip the first SKIP_FIRST_CNT, keep one in SKIP_CNT+1,
        skip within SKIP_DIS), then the landmark payload, host numpy over
        estimator state that the next frame mutates.  The device half is
        `_pg_process`.  Returns None when a gate holds the keyframe back."""
        est = self.estimator
        if self._pg_skip_first < self.cfg.pg_skip_first_cnt:
            self._pg_skip_first += 1
            return None
        if self._pg_skip_count < self.cfg.pg_skip_cnt:
            self._pg_skip_count += 1
            return None
        self._pg_skip_count = 0

        db = est.db
        kf_frame = est.F - 3  # post-slide WINDOW-2: the second-newest frame
        t = est.timestamps[kf_frame]
        p_b = est.p[kf_frame].copy()
        q_b = est.q[kf_frame].copy()
        if np.linalg.norm(p_b - self._pg_last_t) <= self.cfg.pg_skip_dis:
            return None
        img_kf = next((im for ti, im in self._img_ring if abs(ti - t) < 1e-6), None)
        if img_kf is None:
            return None
        # landmarks seen in that frame with solved depth, anchored earlier
        # (start_frame < WINDOW-2, visualization.cpp:378)
        m = db.used & db.valid[:, kf_frame] & (db.inv_depth > 0) & (db.anchor < kf_frame)
        ks = np.nonzero(m)[0]
        if len(ks) < 10:
            return None
        pts3d = self._world_points(ks)

        # padded to a fixed slot count, so that every keyframe has the shapes
        # of the first; 2D pads parked far outside the image, where no
        # nearest-landmark search can select them
        L = self.cfg.max_landmarks
        n = min(len(ks), L)

        def pad(a, fill):
            return np.concatenate([a[:n], np.full((L - n,) + a.shape[1:], fill, a.dtype)])

        self._pg_last_t = np.asarray(p_b, float).copy()
        return {
            "t": float(t), "p_b": p_b, "q_b": q_b,
            "pts3d": pad(pts3d, 0.0),
            "pts2d": pad(db.pt[ks, kf_frame], 1e9),
            "uv": pad(db.uv[ks, kf_frame], 0.0),
            "fids": pad(db.ids[ks], -1),
            "n_landmarks": n,
            "tic": est.tic.copy(), "sequence": self.sequence,
            "img": img_kf,
        }

    def _pg_process(self, payload: dict) -> dict:
        """The device half of the keyframe hand-off and the pose graph's
        ingestion (the reference's pose_graph process() thread): one upload of
        the poses and window points, the keyframe feature function (BRIEF at
        the window points, FAST corners with BRIEF, two-view corner depth
        against the previous keyframe), one fetch of the corner depths, then
        `PoseGraph.add_keyframe` (query → verification → throttled 4-DoF
        solve).  A verified loop's match goes to fast relocalization: queued
        for the frame loop when async, applied at once when not."""
        dev = self.device
        p_b, q_b = payload["p_b"], payload["q_b"]
        L = len(payload["pts3d"])
        with self.pg_tracer.span("pg_features"):
            R_b = nplie.q2R(q_b)
            p_cam = (p_b + R_b @ payload["tic"]).astype(np.float32)
            R_wc = (R_b @ nplie.q2R(self.estimator.qic)).astype(np.float32)
            prev = self._prev_kf_fast
            if prev is None:
                prev = {"pts": torch.zeros((N_FAST, 2), device=dev),
                        "desc": torch.zeros((N_FAST, 256), device=dev),
                        "valid": torch.zeros(N_FAST, dtype=torch.bool, device=dev),
                        "p": np.zeros(3, np.float32), "R": np.eye(3, dtype=np.float32)}
            wvalid = np.arange(L) < payload["n_landmarks"]
            d = _upload(np.concatenate([
                prev["p"], prev["R"].reshape(-1), p_cam, R_wc.reshape(-1),
                np.asarray(payload["uv"]).reshape(-1), wvalid]).astype(np.float32), dev)
            prev_p, prev_R = d[0:3], d[3:12].reshape(3, 3)
            p_c, R_c = d[12:15], d[15:24].reshape(3, 3)
            uv = d[24:24 + 2 * L].reshape(L, 2)
            window_valid = d[24 + 2 * L:] > 0.5
            img = payload["img"]
            img = (img.to(device=dev, dtype=torch.float32) if torch.is_tensor(img)
                   else _upload(np.asarray(img, np.float32), dev))
            wdesc, fpts, fdesc, fok, X3, ok3 = keyframe_features(
                img, uv, self.camera, prev["pts"], prev["desc"], prev["valid"], prev_p, prev_R,
                p_c, R_c, max_fast=N_FAST)
            h = torch.cat([X3.reshape(-1), ok3.to(X3.dtype)]).cpu().numpy()  # one fetch
            self._prev_kf_fast = {"pts": fpts, "desc": fdesc, "valid": fok, "p": p_cam,
                                  "R": R_wc}

        kf = KeyFrame(
            index=-1, stamp=payload["t"], p_vio=p_b, q_vio=q_b, points_3d=payload["pts3d"],
            points_2d_norm=payload["pts2d"], window_desc=wdesc, window_valid=window_valid,
            fast_pts_norm=fpts, fast_desc=fdesc, fast_valid=fok, sequence=payload["sequence"],
            point_ids=payload["fids"], window_uv=payload["uv"],
            image=img if self.cfg.debug_image else None,
            fast_3d=h[:3 * N_FAST].reshape(N_FAST, 3), fast_3d_valid=h[3 * N_FAST:] > 0.5)
        with self.pg_tracer.span("pg_add"):
            res = self.pose_graph.add_keyframe(kf)
        res["stamp"] = payload["t"]
        match = self.pose_graph.last_match
        if res.get("loop") is not None and self.cfg.fast_relocalization and match is not None:
            if self.pg_async:
                # to the frame loop, which owns the estimator (the reference's
                # match_points topic → estimator relo_buf)
                self._relo_queue.append(match)
            else:
                self._apply_relo(match)
        if res.get("loop") is not None and self.cfg.debug_image:
            with self.pg_tracer.span("loop_image"):
                self.last_loop_image = self._render_loop_match(kf)
            if self.last_loop_image is not None and self.loop_image_sink is not None:
                self.loop_image_sink(res["index"], self.last_loop_image)
        return res

    def _render_loop_match(self, kf):
        """Side-by-side loop-match image (keyframe.cpp:416-468's DEBUG_IMAGE
        loop_match) from the stored keyframe images: the old keyframe's
        matched points (normalized coordinates) projected to pixels on the
        pipeline's device, the current keyframe's pixels of the matched ids;
        the images go to the host only for the drawing."""
        from .utils.viz import draw_loop_match

        match = self.pose_graph.last_match
        if match is None or kf.image is None:
            return None
        old = self.pose_graph.keyframes[match["old_index"]]
        if old.image is None:
            return None
        pts = torch.as_tensor(np.asarray(match["pts_old"], float), device=self.device)
        rays = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=1)
        uv_old = self.camera.project(rays)
        id2uv = {int(i): kf.window_uv[k] for k, i in enumerate(kf.point_ids)}
        uv_cur = np.stack([id2uv.get(int(i), np.zeros(2)) for i in match["ids"]])
        return draw_loop_match(kf.image, old.image, uv_cur, uv_old)

    def _apply_relo(self, match: dict):
        """A loop match back through the estimator (the reference's
        match_points → setReloFrame round trip): it arms relo factors in the
        next window solve (estimator.cpp:769-801), whose event carries the
        refined loop edge to `_maybe_relo_feedback`.  Runs on the frame
        loop, which owns the estimator."""
        if self.estimator.set_relo_frame(match["stamp"], match["ids"],
                                         match["pts_old"]) is not None:
            self._relo_kf_index = match["kf_index"]

    def _maybe_relo_feedback(self, ev: dict):
        """relo_relative_pose → updateKeyFrameLoop (pose_graph.cpp:889-923)."""
        relo = ev.get("relo")
        if relo is not None and relo.get("ok") and self._relo_kf_index is not None:
            self.pose_graph.update_keyframe_loop(self._relo_kf_index, relo["rel_t"],
                                                 relo["rel_q"], relo["rel_yaw"])
            self._relo_kf_index = None

    def debug_track_overlay(self):
        """Tracking overlay of the latest processed frame
        (feature_tracker_node.cpp:167-201); None before the first frame."""
        from .utils.viz import draw_track_overlay

        tr = self.tracker
        if tr.prev_img is None:
            return None
        m = tr.valid
        return draw_track_overlay(tr.prev_img, tr.pts[m], tr.track_cnt[m],
                                  window=self.cfg.window * 2)

    def print_statistics(self) -> str:
        """Textual report (printStatistics, visualization.cpp:92-137): pose,
        cost and failures, extrinsics, td, path length, the pose graph, then
        the stage timings (the frame loop's tracer, then the pose-graph
        worker's when it has its own)."""
        est = self.estimator
        p = est.p[est.W]
        lines = [f"position: [{p[0]:.3f} {p[1]:.3f} {p[2]:.3f}]  "
                 f"cost: {est.last_cost:.3e}  failures: {est.failures}",
                 f"extrinsic tic: {np.round(est.tic, 4).tolist()}  "
                 f"qic: {np.round(est.qic, 5).tolist()}  td: {est.td * 1e3:.2f} ms"]
        if len(self.trajectory) >= 2:
            pp = np.stack([e[1] for e in self.trajectory])
            lines.append(f"path length: {np.linalg.norm(np.diff(pp, axis=0), axis=1).sum():.2f} m "
                         f"over {len(self.trajectory)} frames")
        if self.pose_graph is not None:
            nl = sum(1 for k in self.pose_graph.keyframes if k.loop_index >= 0)
            lines.append(f"pose graph: {len(self.pose_graph.keyframes)} keyframes, "
                         f"{nl} loop edges")
        lines.append(self.tracer.stats.report())
        if self.pg_tracer is not self.tracer and self.pg_tracer.stats.snapshot():
            lines.append(self.pg_tracer.stats.report())
        return "\n".join(lines)

    def landmarks_world(self) -> np.ndarray:
        """The solved landmarks in world coordinates (pubPointCloud's
        payload, visualization.cpp)."""
        db = self.estimator.db
        ks = np.nonzero(db.used & (db.inv_depth > 0))[0]
        return self._world_points(ks) if len(ks) else np.zeros((0, 3))

    # ---------------------------------------------------------------- admin

    def pg_join(self):
        """End of stream: drain the overlapped mode's pending frame and the
        worker's queue, apply the queued relocalization matches and force the
        pending 4-DoF solve."""
        self.flush_frames()
        if self.pg_async:
            self._pg_queue.join()
        while self._relo_queue:
            self._apply_relo(self._relo_queue.pop(0))
        if self.pose_graph is not None:
            self.pose_graph.flush()

    def shutdown(self):
        """Stop the pose-graph worker (call before the process exits: a
        daemon thread killed inside a device call can abort it)."""
        if self.pg_async and self._pg_thread.is_alive():
            self._pg_queue.put(None)
            self._pg_thread.join(timeout=120)
            self.pg_async = False

    def _restart(self):
        """Stream fault: reboot the front-end and the estimator, drop the
        overlapped mode's pending work and open a new sequence (the
        reference's restart topic and new_sequence)."""
        self.tracker.reset()
        self.estimator.clear_state()
        self.propagator.reset()
        self._first_image_time = None
        self._pub_count = 0
        self._img_ring.clear()
        self._prev_kf_fast = None
        self._pending = None
        self._est_pending = None
        self._imu_backlog.clear()
        self.sequence += 1

    def write_trajectories(self, path_vio: str, path_loop: str | None = None):
        """The VIO trajectory, and the pose-graph-corrected one when
        `path_loop` is given, in TUM format."""
        from .io.euroc import write_tum

        for path, traj in ((path_vio, self.trajectory), (path_loop, self.trajectory_loop)):
            if path and traj:
                t, p, q = zip(*traj)
                write_tum(path, np.asarray(t), np.stack(p), np.stack(q))
