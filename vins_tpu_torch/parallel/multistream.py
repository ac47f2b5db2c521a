"""Batched multi-stream pipeline: S independent VIO streams on one card.

PyTorch counterpart of `vins_tpu/parallel/multistream.py`.  S camera+IMU
streams run in lock-step through two batched device programs per frame
tick:

  * one front step over the stacked tracker states and images [S,H,W]
    (`fused.make_front_step_b`): the LK kernel runs every level of every
    stream in one launch, and a published tick fetches the [S, D] blobs in
    one copy;
  * one VIO step over the stacked window blobs [S, D] and the stacked prior
    (`estimator.BatchedStep`): one CUDA graph replay per tick, one copy of
    the results.

Host bookkeeping (feature DB, sliding, keyframe decisions, pose graphs)
stays per stream, through the single-stream code (`Estimator.pre_step`,
`post_step`).  Streams still in INITIAL go through their own
`Estimator.process_image`; once NON_LINEAR they join the batch, and a stream
that reboots leaves it.  The batched step's result is fetched one published
tick late, as the JAX driver does: its copy lands while the next tick's
front step runs.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..estimator.estimator import NON_LINEAR, BatchedStep
from ..frontend.fused import make_front_state_b
from ..pipeline import Pipeline
from ..solver.problem import Prior
from ..utils.trace import Tracer

RING = 6  # published frames kept for the keyframe hand-off


class MultiPipeline:
    """S lock-step pipelines sharing batched device programs.

    Each stream keeps its own `Pipeline` (estimator, tracker host mirrors,
    pose graph, trajectories); the device work is batched.  `tracer` times
    the host by span (`ms_front_dispatch`, `ms_front_fetch`, `ms_host_pre`,
    `ms_est_dispatch`, `ms_est_fetch`, `ms_downstream`) and never waits for
    the device."""

    def __init__(self, make_pipe, S: int, loop_closure: bool = True):
        self.S = S
        self.loop_closure = loop_closure
        self.pipes: list[Pipeline] = [make_pipe(s) for s in range(S)]
        p0 = self.pipes[0]
        self.cfg = p0.cfg
        self.device = p0.device
        self.tracer = Tracer()
        # batched estimator step over (blobs [S,D], stacked prior), the prior
        # on the device; each slot starts from its stream's prior
        self.est_step = BatchedStep(p0.estimator, S)
        for s, p in enumerate(self.pipes):
            self._set_prior(s, p.estimator.prior)
        self._front_step = p0.tracker.batched_step()
        self._front_state_b = None
        self._has_prev = False
        # the deferred batched estimator result {pending, batch_idx,
        # batch_marg, t, events}
        self._est_pending = None
        # IMU samples that arrive while a deferred solve is outstanding: they
        # belong to the next interval and must not enter the window buffers
        # until the deferred post_step has slid them
        self._imu_backlog = [[] for _ in range(S)]

    @property
    def sync_check(self) -> bool:
        return self.est_step.sync_check

    @sync_check.setter
    def sync_check(self, on: bool):
        self.est_step.sync_check = bool(on)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A small host array on the device without a host sync: a pinned
        copy, sent non-blocking (the caching host allocator keeps the pinned
        block until the copy has read it)."""
        if self.device.type != "cuda":
            return torch.from_numpy(a)
        host = torch.empty(a.shape, dtype=torch.from_numpy(a).dtype, pin_memory=True)
        host.numpy()[:] = a
        return host.to(self.device, non_blocking=True)

    # ------------------------------------------------------------------ IMU

    def process_imu(self, s: int, t: float, acc, gyr):
        """Stream s's IMU sample (host stores only; the IMU-rate propagator
        output is not kept in batched mode, as in the JAX driver)."""
        pipe = self.pipes[s]
        dt = t - pipe.propagator.t if pipe.propagator.t is not None else 0.0
        pipe.propagator.t = t
        if self._est_pending is not None:
            self._imu_backlog[s].append((dt, acc, gyr))
        else:
            pipe.estimator.process_imu(dt, acc, gyr)

    # ---------------------------------------------------------------- frame

    def process_images(self, imgs, t: float, publish: bool = True, gumbel=None) -> list:
        """One synchronized frame tick for all S streams.  `imgs` [S,H,W] (a
        tensor, or stackable host arrays); `gumbel` [S,64,M] replaces the
        trackers' own RANSAC draws.  Returns the per-stream events of the
        previous published tick (its deferred estimator result)."""
        S = self.S
        trs = [p.tracker for p in self.pipes]
        tr0 = trs[0]
        if self._front_state_b is None:
            h, w = imgs.shape[-2:]
            self._front_state_b = make_front_state_b(S, tr0.M, h, w, tr0.dtype, tr0.device)
        dts = np.asarray([np.float32(t - tr.prev_time) if tr.prev_time is not None else 0.0
                          for tr in trs], np.float32)
        n_ids = np.asarray([tr.n_id for tr in trs], np.int32)
        if publish and self._has_prev:
            if gumbel is None:
                gumbel = torch.stack([tr.draw() for tr in trs])
            elif not torch.is_tensor(gumbel):
                gumbel = torch.from_numpy(np.array(gumbel, np.float32))
            gumbel = gumbel.to(device=tr0.device, dtype=torch.float32)

        tracer = self.tracer
        with tracer.span("ms_front_dispatch"):
            self._front_state_b, blobs = self._front_step(
                self._front_state_b, imgs, self._upload(dts), gumbel, self._upload(n_ids),
                publish=bool(publish), has_prev=self._has_prev)
        self._has_prev = True
        for tr in trs:
            tr.prev_time = t
        if not publish:
            return [{"published": False}] * S

        # complete last tick's deferred estimator result first: its
        # post_step and slide must land before this tick's pre_steps
        events_prev = self._complete_est()
        with tracer.span("ms_front_fetch"):
            blobs_h = blobs.cpu().numpy()
        events: list = [None] * S
        batch_idx: list[int] = []
        batch_blobs: list[np.ndarray] = []
        batch_marg: list[bool] = []
        t0 = time.perf_counter()
        for s in range(S):
            feats = trs[s].adopt_host(blobs_h[s])
            est = self.pipes[s].estimator
            if est.solver_flag == NON_LINEAR:
                # the reference driver passes no rolling-shutter offsets here
                blob, marg = est.pre_step(feats.ids, feats.pts, feats.vel, feats.uv, t)
                batch_idx.append(s)
                batch_blobs.append(blob)
                batch_marg.append(marg)
            else:
                # INITIAL streams take the per-stream path
                events[s] = est.process_image(feats.ids, feats.pts, feats.vel, feats.uv, t)
                if est.solver_flag == NON_LINEAR:
                    # joins the batch from the next tick: its prior slot
                    self._set_prior(s, est.prior)
        tracer.stats.add("ms_host_pre", (time.perf_counter() - t0) * 1e3)
        if batch_idx:
            # streams outside the batch still take a slot (the program has a
            # fixed batch S): zeros, whose result and prior are discarded
            full = np.zeros((S,) + batch_blobs[0].shape, batch_blobs[0].dtype)
            sel = np.zeros(S, bool)
            for k, s in enumerate(batch_idx):
                full[s] = batch_blobs[k]
                sel[s] = True
            with tracer.span("ms_est_dispatch"):
                pending = self.est_step.dispatch(full, sel)
            self._est_pending = {"pending": pending, "batch_idx": batch_idx,
                                 "batch_marg": batch_marg, "t": t, "events": events}
        return events_prev

    def _complete_est(self) -> list:
        """Fetch and apply the deferred batched estimator result; run each
        stream's downstream (trajectories, relocalization, keyframe
        hand-off)."""
        if self._est_pending is None:
            return []
        p = self._est_pending
        self._est_pending = None
        S = self.S
        tracer = self.tracer
        with tracer.span("ms_est_fetch"):
            res_all = self.est_step.fetch(p["pending"])
        events = p["events"]
        t = p["t"]
        for k, s in enumerate(p["batch_idx"]):
            est = self.pipes[s].estimator
            ev = est.post_step(res_all[s], p["batch_marg"][k], failure_check=True)
            ev["kind"] = "vio" if ev.get("ok", True) else "reboot"
            if not ev.get("ok", True):
                # rebooted: the slot takes the cleared estimator's prior
                self._set_prior(s, est.prior)
            events[s] = ev
        # release the held IMU samples into the freshly slid buffers
        for s in range(S):
            for dt, acc, gyr in self._imu_backlog[s]:
                self.pipes[s].estimator.process_imu(dt, acc, gyr)
            self._imu_backlog[s].clear()

        t1 = time.perf_counter()
        for s in range(S):
            self.pipes[s]._downstream(events[s], t, rebase=False)
        tracer.stats.add("ms_downstream", (time.perf_counter() - t1) * 1e3)
        return events

    def _set_prior(self, s: int, prior: Prior):
        """Stream s's slot of the stacked prior ← prior (a stream joining the
        batch or rebooting)."""
        self.est_step.set_prior(s, prior)

    def push_image_ring(self, s: int, t: float, img):
        """Keep stream s's keyframe image ring fed (the pose-graph hand-off)."""
        pipe = self.pipes[s]
        pipe._img_ring.append((t, img))
        if len(pipe._img_ring) > RING:
            pipe._img_ring.pop(0)

    def finish(self):
        """End of the streams: complete the deferred step (its events are
        discarded, as the JAX driver's are), drain and stop every pose-graph
        worker."""
        self._complete_est()
        for p in self.pipes:
            p.pg_join()
            p.shutdown()
