"""Initialization orchestration: SfM + visual-inertial alignment.

PyTorch counterpart of `vins_tpu/estimator/initializer.py`, the host side of
Estimator::initialStructure + visualInitialAlign (estimator.cpp:218-440):

  excitation check → reference-frame search (relativePose, estimator.cpp:
  442-471) → GlobalSFM → gyro-bias solve + repropagation → linear alignment
  with gravity refinement → state application (gravity-aligned world, yaw of
  frame 0 zeroed, velocities rotated to world, depths reset).

The primary path aligns over a fixed-size ring of recent published frames
(`make_align_all_pipeline`, the reference's `all_image_frame`), falling
back to the window keyframes (`make_align_pipeline`).  Both pipelines are
plain functions on device tensors; the initializer reads their results
back to the host once per attempt.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import lie
from ..frontend.tracker import N_HYP, gumbel_draw
from ..imu.preintegration import ImuNoise, preintegrate
from ..init.alignment import solve_gyro_bias, visual_imu_alignment
from ..init.relative_pose import solve_relative_pose
from ..init.sfm import construct_sfm, pnp_gn


class InitResult(NamedTuple):
    ok: bool
    reason: str
    p: np.ndarray | None = None  # [F,3]
    q: np.ndarray | None = None  # [F,4]
    v: np.ndarray | None = None  # [F,3]
    bg: np.ndarray | None = None  # [3]
    scale: float = 0.0
    g_var: float = 0.0
    s_rel_sigma: float = 0.0  # relative 1σ of the alignment's scale estimate


def _world_align(g_c0, R_wb, Ps, Vs):
    """Rotate the world so gravity is +z and frame 0 has zero yaw
    (estimator.cpp:424-435); returns (Ps, q [F,4], Vs)."""
    R0 = lie.g2R(g_c0)
    yaw0 = lie.R2ypr(R0 @ R_wb[0])[0]
    zero = torch.zeros_like(yaw0)
    R0 = lie.ypr2R(torch.stack([-yaw0, zero, zero])) @ R0
    R_wb = torch.einsum("ij,fjk->fik", R0, R_wb)
    return Ps @ R0.T, lie.R2q(R_wb), Vs @ R0.T


def make_align_pipeline(noise: ImuNoise, g_norm: float):
    """SfM + gyro bias + repropagation + alignment over the window
    keyframes."""

    def pipeline(pt, valid, l, R_rel, t_rel, qic, tic, imu_dt, imu_acc, imu_gyr, imu_mask):
        zero3 = torch.zeros(3, dtype=pt.dtype, device=pt.device)
        sfm = construct_sfm(pt, valid, l, R_rel, t_rel)
        # body rotations in the SfM (camera-l) frame: R_wb = R_wc · Ricᵀ
        q_wb = lie.qmul(sfm.q_wc, lie.qconj(qic))
        pres0 = preintegrate(imu_dt, imu_acc, imu_gyr, zero3, zero3, noise, imu_mask)
        dbg = solve_gyro_bias(q_wb, pres0)
        pres1 = preintegrate(imu_dt, imu_acc, imu_gyr, zero3, dbg.expand(imu_dt.shape[0], 3),
                             noise, imu_mask)
        align = visual_imu_alignment(q_wb, sfm.p_wc, tic, pres1, g_norm)

        # apply (visualInitialAlign, estimator.cpp:364-440)
        R_wb = lie.q2R(q_wb)
        Ps = align.scale * sfm.p_wc - R_wb @ tic
        Ps = Ps - Ps[0]
        Vs = (R_wb @ align.v_body[..., None])[..., 0]
        Ps, q_out, Vs = _world_align(align.g_c0, R_wb, Ps, Vs)
        return Ps, q_out, Vs, dbg, align.scale, sfm.ok, align.ok, align.s_rel_sigma

    return pipeline


def make_align_all_pipeline(noise: ImuNoise, g_norm: float):
    """All-frames initialization (estimator.cpp:340-362 solvePnP per frame +
    visualInitialAlign over every published frame, initial_alignment.h:
    13-27): SfM over the window keyframes, PnP for every aux frame against
    the SfM landmarks, then gyro bias + alignment over the aux chain."""

    def pipeline(pt, valid, l, R_rel, t_rel, qic, tic, aux_obs, aux_w, aux_fmask, win_idx,
                 win_sel, aux_dt, aux_acc, aux_gyr, aux_mask):
        zero3 = torch.zeros(3, dtype=pt.dtype, device=pt.device)
        sfm = construct_sfm(pt, valid, l, R_rel, t_rel)

        # PnP for every aux frame against SfM landmarks, initialized from the
        # nearest window keyframe's SfM camera pose
        w = aux_w * sfm.has_pt[None, :].to(pt.dtype)
        p_a, q_a, ok_a = pnp_gn(sfm.pts, aux_obs, w, sfm.p_wc[win_idx], sfm.q_wc[win_idx])
        pnp_ok = torch.all(ok_a | ~aux_fmask)
        q_wb_a = lie.qmul(q_a, lie.qconj(qic))

        # interval j chains aux frames j→j+1; valid iff frame j+1 is real
        int_mask = aux_fmask[1:]
        K = aux_dt.shape[0]
        pres0 = preintegrate(aux_dt, aux_acc, aux_gyr, zero3, zero3, noise, aux_mask)
        dbg = solve_gyro_bias(q_wb_a, pres0, mask=int_mask)
        pres1 = preintegrate(aux_dt, aux_acc, aux_gyr, zero3, dbg.expand(K, 3), noise, aux_mask)
        align = visual_imu_alignment(q_wb_a, p_a, tic, pres1, g_norm, mask=int_mask)

        # apply to the WINDOW (velocities gathered from the aux chain,
        # estimator.cpp:393-404)
        q_wb = lie.qmul(sfm.q_wc, lie.qconj(qic))
        R_wb = lie.q2R(q_wb)
        Ps = align.scale * sfm.p_wc - R_wb @ tic
        Ps = Ps - Ps[0]
        Vs = (lie.q2R(q_wb_a) @ align.v_body[..., None])[..., 0][win_sel]
        Ps, q_out, Vs = _world_align(align.g_c0, R_wb, Ps, Vs)
        return (Ps, q_out, Vs, dbg, align.scale, sfm.ok & pnp_ok, align.ok,
                align.s_rel_sigma)

    return pipeline


def _host(xs):
    """One batch of device results → numpy (a single copy per tensor after
    one device sync)."""
    return [x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x) for x in xs]


class Initializer:
    # scale-observability acceptance (see the reference package): reject an
    # alignment whose scale estimate carries more than this relative 1σ
    SCALE_REL_SIGMA_MAX = 1.0

    def __init__(self, noise: ImuNoise, g_norm: float, focal: float = 460.0,
                 dtype=torch.float64, device="cuda", gumbel=None):
        self.noise = noise
        self.g_norm = g_norm
        self.focal = focal
        self.dtype = dtype
        self.device = torch.device(device)
        self._pipeline = make_align_pipeline(noise, g_norm)
        self._pipeline_all = make_align_all_pipeline(noise, g_norm)
        # RANSAC draws of the reference-frame search: `gumbel(shape)` returns
        # standard Gumbel draws; by default from a generator seeded 0
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self.gumbel = gumbel or (lambda shape: gumbel_draw(shape, self._gen, self.device))

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype).to(self.device)

    def excitation_variance(self, imu_dt, imu_acc, imu_gyr, imu_n) -> float:
        """std of per-interval mean specific force (estimator.cpp:221-248) —
        the reference only warns below 0.25, never aborts."""
        gs = []
        for k in range(imu_dt.shape[0]):
            n = int(imu_n[k])
            if n == 0 or imu_dt[k, :n].sum() <= 0:
                continue
            gs.append(imu_acc[k, 1:n + 1].mean(0))
        if len(gs) < 2:
            return 0.0
        gs = np.stack(gs)
        return float(np.linalg.norm(gs - gs.mean(0), axis=1).mean())

    def find_reference_frame(self, db):
        """relativePose (estimator.cpp:442-471): the first frame l with ≥20
        correspondences to the newest frame and mean parallax·focal > 30 px
        whose essential solve succeeds.  Returns (l, RelPose) or None."""
        F = db.F
        for l in range(F - 1):
            both = db.used & db.valid[:, l] & db.valid[:, F - 1]
            if both.sum() < 20:
                continue
            parallax = np.linalg.norm(db.pt[both, l] - db.pt[both, F - 1], axis=1).mean()
            if parallax * self.focal < 30.0:
                continue
            rel = solve_relative_pose(
                self._t(db.pt[:, l]), self._t(db.pt[:, F - 1]),
                self._t(db.valid[:, l] & db.valid[:, F - 1] & db.used, torch.bool),
                self.gumbel((N_HYP, db.L)))
            if bool(rel.ok):
                return l, rel
        return None

    def _build_aux_inputs(self, db, est, win_ts):
        """Host-side packing of the all-frames ring into fixed-shape pipeline
        inputs; None when the ring cannot serve (too few frames, or a window
        frame already evicted)."""
        A = est.A
        count = min(est.aux_count, A)
        F = db.F
        if count < F + 2:
            return None
        if est.aux_count <= A:
            order = np.arange(count)
        else:
            order = (np.arange(A) + est.aux_count % A) % A
        full = np.concatenate([order, np.zeros(A - count, np.int64)])
        ts = est.aux_t[full]

        # every window frame must still be in the ring (timestamps match)
        win_sel = np.clip(np.searchsorted(ts[:count], win_ts), 0, count - 1)
        if not np.allclose(ts[win_sel], win_ts, atol=1e-9):
            return None

        # per-aux-frame observations scattered into landmark slots
        L = db.L
        aux_obs = np.zeros((A, L, 2))
        aux_w = np.zeros((A, L))
        sort = np.argsort(db.ids)
        sids = db.ids[sort]
        for a in range(count):
            ids_a = est.aux_ids[full[a]]
            ok = ids_a >= 0
            pos = np.clip(np.searchsorted(sids, ids_a[ok]), 0, L - 1)
            hit = sids[pos] == ids_a[ok]
            slots = sort[pos[hit]]
            aux_obs[a, slots] = est.aux_pt[full[a]][ok][hit]
            aux_w[a, slots] = 1.0

        fmask = np.zeros(A, bool)
        fmask[:count] = True
        # nearest window keyframe per aux frame (PnP initial pose)
        wi = np.clip(np.searchsorted(win_ts, ts), 0, F - 1)
        lo = np.clip(wi - 1, 0, F - 1)
        win_idx = np.where(np.abs(win_ts[lo] - ts) < np.abs(win_ts[wi] - ts), lo, wi)
        imask = np.arange(est.Ni)[None, :] < est.aux_n[full][:, None]
        return dict(aux_obs=aux_obs, aux_w=aux_w, fmask=fmask, win_idx=win_idx,
                    win_sel=win_sel, dt=est.aux_dt[full][1:], acc=est.aux_acc[full][1:],
                    gyr=est.aux_gyr[full][1:], imask=imask[1:])

    def try_initialize(self, db, imu_dt, imu_acc, imu_gyr, imu_n, qic, tic, est=None,
                       win_ts=None) -> InitResult:
        g_var = self.excitation_variance(imu_dt, imu_acc, imu_gyr, imu_n)
        # (the reference warns when < 0.25 but proceeds — estimator.cpp:245-247)
        found = self.find_reference_frame(db)
        if found is None:
            return InitResult(False, "no reference frame with enough parallax", g_var=g_var)
        l, rel = found

        t = self._t
        pt = t(db.pt)
        valid = t(db.valid & db.used[:, None], torch.bool)
        R_rel, t_rel = rel.R.to(self.dtype), rel.t.to(self.dtype)

        # all-frames path (all_image_frame, estimator.cpp:340-440)
        aux = None
        if est is not None and win_ts is not None:
            aux = self._build_aux_inputs(db, est, np.asarray(win_ts))
        if aux is not None:
            Ps, q, Vs, dbg, s, sfm_ok, align_ok, s_sig = _host(self._pipeline_all(
                pt, valid, l, R_rel, t_rel, t(qic), t(tic), t(aux["aux_obs"]),
                t(aux["aux_w"]), t(aux["fmask"], torch.bool), t(aux["win_idx"], torch.int64),
                t(aux["win_sel"], torch.int64), t(aux["dt"]), t(aux["acc"]), t(aux["gyr"]),
                t(aux["imask"], torch.bool)))
            if bool(sfm_ok) and bool(align_ok) and float(s_sig) < self.SCALE_REL_SIGMA_MAX:
                return InitResult(True, "ok (all frames)", p=Ps, q=q, v=Vs, bg=dbg,
                                  scale=float(s), g_var=g_var, s_rel_sigma=float(s_sig))
            # fall through to the window-only path

        N = imu_dt.shape[1]
        mask = np.arange(N)[None, :] < imu_n[:, None]
        Ps, q, Vs, dbg, s, sfm_ok, align_ok, s_sig = _host(self._pipeline(
            pt, valid, l, R_rel, t_rel, t(qic), t(tic), t(imu_dt), t(imu_acc), t(imu_gyr),
            t(mask, torch.bool)))
        if not bool(sfm_ok):
            return InitResult(False, "global SfM failed", g_var=g_var)
        if not bool(align_ok):
            return InitResult(False, "visual-inertial alignment rejected", g_var=g_var)
        if float(s_sig) >= self.SCALE_REL_SIGMA_MAX:
            return InitResult(False, f"scale unobservable (rel sigma {float(s_sig):.2f})",
                              g_var=g_var, s_rel_sigma=float(s_sig))
        return InitResult(True, "ok", p=Ps, q=q, v=Vs, bg=dbg, scale=float(s), g_var=g_var,
                          s_rel_sigma=float(s_sig))
