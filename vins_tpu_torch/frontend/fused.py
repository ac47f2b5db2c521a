"""The whole per-frame front-end as one step over device-resident state.

PyTorch counterpart of `vins_tpu/frontend/fused.py`.  The step runs CLAHE,
pyramidal LK, essential-RANSAC rejection, Shi-Tomasi top-up, undistortion
and velocity on the tracker state without syncing the host, and returns one
packed f32 blob with the reference's layout, so a published frame costs one
device-to-host copy and a track-only frame none.

Slot bookkeeping is rank arithmetic: candidates are ranked by detector
response, free slots by index, and candidate k fills the k-th free slot with
id = n_id + k.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..init.relative_pose import solve_relative_pose
from .detect import detect_grid, shi_tomasi_response
from .image import clahe
from .klt import lk_pyramidal


class FrontState(NamedTuple):
    pts: torch.Tensor        # [M,2] pixel positions
    valid: torch.Tensor      # [M] bool
    track_cnt: torch.Tensor  # [M] int32
    ids: torch.Tensor        # [M] int32 (−1 = free)
    prev_un: torch.Tensor    # [M,2] previous frame's normalized points
    prev_ids: torch.Tensor   # [M] ids at the previous frame (−1 = invalid)
    prev_img: torch.Tensor   # [H,W] previous CLAHE'd image


def make_front_state(max_cnt: int, h: int, w: int, dtype=torch.float32,
                     device="cuda") -> FrontState:
    M = max_cnt
    kw = dict(device=device)
    return FrontState(
        pts=torch.zeros((M, 2), dtype=dtype, **kw),
        valid=torch.zeros((M,), dtype=torch.bool, **kw),
        track_cnt=torch.zeros((M,), dtype=torch.int32, **kw),
        ids=torch.full((M,), -1, dtype=torch.int32, **kw),
        prev_un=torch.zeros((M, 2), dtype=dtype, **kw),
        prev_ids=torch.full((M,), -1, dtype=torch.int32, **kw),
        prev_img=torch.zeros((h, w), dtype=dtype, **kw),
    )


def make_front_step(camera, max_cnt: int, min_dist: int, f_threshold: float,
                    equalize: bool, focal: float, win: int = 21, levels: int = 3,
                    fov_mask=None, dtype=torch.float32, device="cuda"):
    """Returns `step(state, img, dt, gumbel, n_id, publish, has_prev)` →
    (new_state, blob).  `gumbel` [64, M] is the RANSAC draw, used only when
    `publish and has_prev`."""
    M = max_cnt
    mask = None if fov_mask is None else torch.as_tensor(
        np.asarray(fov_mask, bool), device=device)

    def lift_norm(pts):
        rays = camera.lift(pts)
        return rays[:, :2] / rays[:, 2:3]

    def step(state: FrontState, img, dt: float, gumbel, n_id: int,
             publish: bool = True, has_prev: bool = True):
        dev = state.pts.device
        if not torch.is_tensor(img):
            img = torch.from_numpy(np.array(img))  # a writable host copy
        im = img.to(device=dev, dtype=dtype)
        if equalize:
            im = clahe(im)

        pts, valid, track_cnt, ids = state.pts, state.valid, state.track_cnt, state.ids

        if has_prev:
            pts, status = lk_pyramidal(state.prev_img, im, pts, valid, win=win,
                                       levels=levels)
            valid = valid & status
            if mask is not None:
                xi = torch.clamp(torch.nan_to_num(pts[:, 0]).to(torch.int64), 0, mask.shape[1] - 1)
                yi = torch.clamp(torch.nan_to_num(pts[:, 1]).to(torch.int64), 0, mask.shape[0] - 1)
                valid = valid & mask[yi, xi]
            track_cnt = torch.where(valid, track_cnt + 1, track_cnt)

        n_new = torch.zeros((), dtype=torch.int32, device=dev)
        if publish:
            if has_prev:
                # essential-RANSAC rejection on undistorted points
                # (rejectWithF, feature_tracker.cpp:169-202), slot-aligned
                un_cur = lift_norm(pts)
                m = valid & (track_cnt > 1) & (state.prev_ids == ids) & (state.prev_ids >= 0)
                rel = solve_relative_pose(state.prev_un.to(dtype), un_cur.to(dtype), m,
                                          gumbel, thresh=f_threshold / focal)
                enough = torch.sum(m) >= 15
                drop = enough & rel.ok & m & ~rel.inliers
                valid = valid & ~drop

            # Shi-Tomasi grid top-up (setMask + goodFeaturesToTrack)
            resp = shi_tomasi_response(im)
            if mask is not None:
                resp = torch.where(mask, resp, torch.full_like(resp, -torch.inf))
            cand, okc = detect_grid(resp, pts, valid, max_new=M, cell=min_dist)
            free = ~valid
            order = torch.argsort((~okc).to(torch.uint8), stable=True)  # ok first, ranked
            cand_sorted = cand[order]
            slot_rank = torch.cumsum(free.to(torch.int32), 0) - 1  # rank of each free slot
            n_take = torch.minimum(torch.sum(free), torch.sum(okc)).to(torch.int32)
            newly = free & (slot_rank < n_take)
            src = torch.clamp(slot_rank, 0, M - 1).long()
            pts = torch.where(newly[:, None], cand_sorted[src], pts)
            ids = torch.where(newly, n_id + slot_rank, ids).to(torch.int32)
            track_cnt = torch.where(newly, torch.ones_like(track_cnt), track_cnt)
            valid = valid | newly
            n_new = n_take

        un = lift_norm(pts)
        same = valid & (state.prev_ids == ids) & (state.prev_ids >= 0)
        if dt > 0:
            vel = torch.where(same[:, None], (un - state.prev_un) / max(dt, 1e-9),
                              torch.zeros_like(un))
        else:
            vel = torch.zeros_like(un)

        pub_mask = valid & (track_cnt > 1)
        new_state = FrontState(
            pts=pts, valid=valid, track_cnt=track_cnt, ids=ids,
            prev_un=un.to(dtype),
            prev_ids=torch.where(valid, ids, torch.full_like(ids, -1)),
            prev_img=im,
        )
        # one packed f32 blob; the integers ride along bitcast to f32
        def as_f(a):
            return a.to(torch.int32).reshape(-1).view(torch.float32)

        blob = torch.cat([
            un.to(torch.float32).reshape(-1),   # [2M]
            vel.to(torch.float32).reshape(-1),  # [2M]
            pts.to(torch.float32).reshape(-1),  # [2M]
            pub_mask.to(torch.float32),         # [M]
            valid.to(torch.float32),            # [M]
            as_f(track_cnt),                    # [M]
            as_f(ids),                          # [M]
            as_f(n_new),                        # [1]
        ])
        return new_state, blob

    return step


def unpack_front_blob(blob: np.ndarray, M: int):
    """Host-side decode of the packed step output (same layout as above)."""
    b = np.asarray(blob, dtype=np.float32)
    o = 0

    def take(n):
        nonlocal o
        out = b[o:o + n]
        o += n
        return out

    un = take(2 * M).reshape(M, 2)
    vel = take(2 * M).reshape(M, 2)
    pts = take(2 * M).reshape(M, 2)
    pub_mask = take(M) > 0.5
    valid = take(M) > 0.5
    track_cnt = take(M).view(np.int32)[:M]
    ids = take(M).view(np.int32)[:M]
    n_new = int(take(1).view(np.int32)[0])
    return un, vel, pts, pub_mask, valid, track_cnt, ids, n_new
