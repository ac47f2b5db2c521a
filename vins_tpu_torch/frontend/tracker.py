"""Feature tracker — the image front-end.

PyTorch counterpart of `vins_tpu/frontend/tracker.py`, the reference's
`FeatureTracker::readImage` (feature_tracker.cpp:81-167):

  CLAHE → pyramidal LK on all slots → border/status rejection →
  [publish frames only:] essential-RANSAC outlier rejection on undistorted
  points → grid top-up detection → undistortion + per-id velocity.

The tracker state stays on the device between frames (`fused.py`); the
host keeps numpy mirrors, refreshed from one blob copy per published frame.
Feature ids are global and increase monotonically (updateID,
feature_tracker_node.cpp:103-111).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .fused import make_front_state, make_front_step, make_front_step_b, unpack_front_blob

N_HYP = 64  # RANSAC hypotheses per published frame


class FrameFeatures(NamedTuple):
    """Wire format toward the estimator (feature_tracker_node.cpp:116-157:
    only features with track_cnt > 1 carry velocity and are published)."""

    ids: np.ndarray  # [K]
    pts: np.ndarray  # [K,2] normalized plane
    vel: np.ndarray  # [K,2] normalized-plane velocity
    uv: np.ndarray   # [K,2] raw pixels


def gumbel_draw(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(U)) with U on (tiny, 1), as
    jax.random.gumbel computes them."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


class FeatureTracker:
    def __init__(
        self,
        camera,
        max_cnt: int = 150,
        min_dist: int = 30,
        f_threshold: float = 1.0,
        equalize: bool = True,
        focal: float = 460.0,
        win: int = 21,
        levels: int = 3,
        mask: np.ndarray | None = None,
        dtype=torch.float32,
        image_shape: tuple[int, int] | None = None,
        device="cuda",
    ):
        self.cam = camera
        self.M = max_cnt
        self.dtype = dtype
        self.device = torch.device(device)
        self.mask = None if mask is None else np.asarray(mask, bool)
        self._front_args = (camera, max_cnt, min_dist, f_threshold, equalize, focal)
        self._front_kw = dict(win=win, levels=levels, fov_mask=self.mask, dtype=dtype,
                              device=self.device)
        self._step = make_front_step(*self._front_args, **self._front_kw)
        self._shape = image_shape  # lazily set from the first image
        self._state = None
        # RANSAC draws; seeded 42 as the reference's PRNGKey(42)
        self._gen = torch.Generator(device=self.device).manual_seed(42)

        # host mirrors (refreshed from the blob on published frames)
        self.pts = np.zeros((max_cnt, 2))
        self.ids = np.full(max_cnt, -1, np.int64)
        self.track_cnt = np.zeros(max_cnt, np.int64)
        self.valid = np.zeros(max_cnt, bool)
        self.prev_time = None
        self.n_id = 0
        self._has_prev = False

    @property
    def prev_img(self):
        return None if not self._has_prev else self._state.prev_img

    def batched_step(self):
        """This tracker's step for S lock-step streams at once
        (`fused.make_front_step_b`, the multi-stream pipeline's)."""
        return make_front_step_b(*self._front_args, **self._front_kw)

    def draw(self) -> torch.Tensor:
        """The next RANSAC draw [64, max_cnt] from this tracker's generator."""
        return gumbel_draw((N_HYP, self.M), self._gen, self.device)

    def _dispatch(self, img, t: float, publish: bool, gumbel):
        if self._state is None:
            h, w = (tuple(img.shape) if self._shape is None else self._shape)
            self._state = make_front_state(self.M, h, w, self.dtype, self.device)
        dt = float(np.float32((t - self.prev_time) if self.prev_time is not None else 0.0))
        if publish and self._has_prev:
            if gumbel is None:
                gumbel = self.draw()
            else:
                if not torch.is_tensor(gumbel):
                    gumbel = torch.from_numpy(np.array(gumbel, np.float32))
                gumbel = gumbel.to(device=self.device, dtype=torch.float32)
        self._state, blob = self._step(
            self._state, img, dt, gumbel, self.n_id,
            publish=bool(publish), has_prev=self._has_prev)
        self.prev_time = t
        self._has_prev = True
        return blob

    def read_image(self, img, t: float, publish: bool = True,
                   gumbel=None) -> FrameFeatures | None:
        """Process one frame ([H,W] numpy array or tensor); returns the
        published features, or None when not a publish frame (the caller
        implements the FREQ controller, feature_tracker_node.cpp:51-62).
        `gumbel` [64, max_cnt] replaces the tracker's own RANSAC draw."""
        blob = self._dispatch(img, t, publish, gumbel)
        if not publish:
            # track-only frames never touch the host: ids are allocated only
            # on publish frames, so the host mirrors may lag until then
            return None
        return self.adopt_blob(blob)

    def read_image_device(self, img, t: float, publish: bool = True, gumbel=None):
        """Overlap-mode half of read_image: run the front step and return the
        device blob without fetching it (a non-blocking copy to pinned host
        memory is started, so a later `adopt_blob` costs little).  Track-only
        frames return None."""
        blob = self._dispatch(img, t, publish, gumbel)
        if not publish:
            return None
        if blob.device.type == "cuda":
            host = torch.empty(blob.shape, dtype=blob.dtype, pin_memory=True)
            host.copy_(blob, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            return host, event
        return blob, None

    def adopt_blob(self, blob) -> FrameFeatures:
        """Fetch + unpack a front blob (a device tensor, or what
        `read_image_device` returned) into the host mirrors and the estimator
        wire format."""
        if isinstance(blob, tuple):
            blob, event = blob
            if event is not None:
                event.synchronize()
        return self.adopt_host(blob.cpu().numpy())

    def adopt_host(self, blob: np.ndarray) -> FrameFeatures:
        """Unpack a fetched front blob into the host mirrors and the
        estimator wire format."""
        un, vel, pts, pub_mask, valid, cnt, ids, n_new = unpack_front_blob(blob, self.M)
        self.pts = np.asarray(pts, float)
        self.valid = valid
        self.track_cnt = cnt.astype(np.int64)
        self.ids = ids.astype(np.int64)
        self.n_id += int(n_new)
        return FrameFeatures(
            ids=self.ids[pub_mask].copy(),
            pts=np.asarray(un, float)[pub_mask],
            vel=np.asarray(vel, float)[pub_mask],
            uv=self.pts[pub_mask].copy(),
        )

    def reset(self):
        self._state = None
        self._has_prev = False
        self.valid[:] = False
        self.ids[:] = -1
        self.track_cnt[:] = 0
        self.prev_time = None
