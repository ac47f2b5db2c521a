"""Sliding-window visual-inertial estimator — the host state machine.

PyTorch counterpart of `vins_tpu/estimator/estimator.py`, the reference's
`Estimator` (vins_estimator/src/estimator.{h,cpp}): INITIAL → NON_LINEAR
over a window of F = WINDOW_SIZE+1 frames.  The heavy math runs on the
device in the initializer and the per-keyframe `vio_step`; this class keeps
the buffers (numpy), the feature DB, sliding and failure recovery.

Per keyframe the device sees one host→device copy (the packed blob, through
a pinned buffer) and gives one device→host copy (the packed result, into a
pinned buffer); the marginalization prior stays on the device.  A step is
split in two: `dispatch` uploads the blob, runs the step and starts the
result copy; `complete` waits for the copy and runs the host half
(`post_step`).  The serial path runs one after the other
(`_solve_and_slide`); the overlapped pipeline runs other work between them.
On CUDA the step is a CUDA graph (`graph.StepGraph`), replayed once per
step; `cuda_graph=False` keeps it eager, for comparisons.  With
`sync_check` set, everything from the upload to the start of the result
copy runs under CUDA sync-debug mode "error", so a host sync inside it
raises.

Wire protocol as the reference nodes:
  * `process_imu(dt, acc, gyr)`   ← Estimator::processIMU (estimator.cpp:84-118)
  * `process_image(ids, pts, vels, uvs, t)` ← processImage (:120-217)
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..config import VinsConfig
from ..core import nplie
from ..frontend.tracker import N_HYP, gumbel_draw
from ..imu.preintegration import ImuNoise
from ..init.ex_rotation import ExRotBuffer, calibrate_ex_rotation, push_pair
from ..init.relative_pose import solve_relative_pose
from ..loop.relocalize import relative_pose_4dof
from ..solver.gn import SolverOptions
from ..solver.problem import FeatureObs, Layout, Prior, WindowState
from .feature_db import FeatureDB
from .graph import BatchStepGraph, StepGraph, copy_prior, slot_prior, stack_priors
from .initializer import Initializer
from .propagator import midpoint_propagate_batch
from .step import StepResult, make_vio_step, where_prior

INITIAL = 0
NON_LINEAR = 1


class PendingStep(NamedTuple):
    """A dispatched step whose result is on its way to the host."""

    host: torch.Tensor              # the packed result (pinned on CUDA)
    event: torch.cuda.Event | None  # recorded after the copy into `host`
    marg_old: bool


class Estimator:
    def __init__(self, cfg: VinsConfig, imu_buf_len: int = 256, dtype=torch.float64,
                 aux_frames: int = 64, aux_imu_len: int = 64, device="cuda",
                 cuda_graph: bool = True):
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        self.F = cfg.frames
        self.W = cfg.window
        self.L = cfg.max_landmarks
        self.N = imu_buf_len
        # all-frames initialization ring (the reference's all_image_frame,
        # initial_alignment.h:13-27): the last `aux_frames` PUBLISHED frames
        # with their observations and inter-frame IMU, used only in INITIAL
        self.A = aux_frames
        self.Ni = aux_imu_len
        self.layout = Layout(self.F)
        self.noise = ImuNoise(cfg.acc_n, cfg.gyr_n, cfg.acc_w, cfg.gyr_w)
        self.opts = SolverOptions(iters=cfg.max_num_iterations, focal=cfg.focal)
        self.gravity = torch.zeros(3, dtype=dtype, device=self.device)
        self.gravity[2:] = cfg.g_norm
        self.sync_check = False

        self.db = FeatureDB(self.L, self.F)
        self.db._min_parallax = cfg.min_parallax

        self.estimate_extrinsic = cfg.estimate_extrinsic
        self._step = make_vio_step(self.layout, self.noise, self.opts,
                                   estimate_extrinsic=cfg.estimate_extrinsic >= 1,
                                   estimate_td=cfg.estimate_td, with_relo=True)
        spec = self._blob_spec()
        sizes = [int(np.prod(shp)) if shp else 1 for _, shp in spec]
        self._offs = np.concatenate([[0], np.cumsum(sizes)]).tolist()
        # pinned staging buffers, each guarded by an event: the host writes
        # the upload buffer only after the previous upload has read it, and
        # reads the result buffer only after its copy has landed
        self._pinned = None
        self._upload_done = None
        self._host_out = None
        self._result_unread = False
        self._graph = (StepGraph(self.packed_step, self._pack_result, self._offs[-1],
                                 Prior.empty(self.layout, dtype, self.device))
                       if cuda_graph and self.device.type == "cuda" else None)
        self._prior = None if self._graph is None else self._graph.prior
        self.initializer = Initializer(self.noise, cfg.g_norm, cfg.focal, dtype, self.device)

        # extrinsics (body←camera)
        self.qic = nplie.R2q(np.asarray(cfg.extrinsic_R, float))
        self.tic = np.asarray(cfg.extrinsic_t, float)
        self.ex_calib_done = cfg.estimate_extrinsic != 2
        self._ex_buf = ExRotBuffer.empty(64, dtype, self.device)
        # RANSAC draws of the calibration's essential solve: `ex_gumbel(shape,
        # frame_count)` returns Gumbel [64, L] float32 (a test substitutes
        # the reference's jax.random draws)
        self.ex_gumbel = lambda shape, seed: gumbel_draw(
            shape, torch.Generator(device=self.device).manual_seed(seed), self.device)

        self.clear_state()

    # ------------------------------------------------------------------ state

    def clear_state(self):
        """Full reboot (Estimator::clearState, estimator.cpp:22-82)."""
        F, W, N = self.F, self.W, self.N
        self.frame_count = 0
        self.solver_flag = INITIAL
        self.initial_timestamp = -1e18
        self.first_imu = False
        self.failures = getattr(self, "failures", 0)

        self.p = np.zeros((F, 3))
        self.q = np.tile(np.array([1.0, 0, 0, 0]), (F, 1))
        self.v = np.zeros((F, 3))
        self.ba = np.zeros((F, 3))
        self.bg = np.zeros((F, 3))
        self.td = float(self.cfg.td)
        self.timestamps = np.zeros(F)

        # raw IMU per interval k = (frame k, frame k+1): boundary-sample layout
        self.imu_dt = np.zeros((W, N))
        self.imu_acc = np.zeros((W, N + 1, 3))
        self.imu_gyr = np.zeros((W, N + 1, 3))
        self.imu_n = np.zeros(W, np.int64)

        self.acc_prev = np.zeros(3)
        self.gyr_prev = np.zeros(3)
        self.imu_overflow = getattr(self, "imu_overflow", 0)

        # all-frames init ring (+ the open interval accumulator)
        A, Ni, M = self.A, self.Ni, self.cfg.max_cnt
        self.aux_t = np.full(A, -1.0)
        self.aux_ids = np.full((A, M), -1, np.int64)
        self.aux_pt = np.zeros((A, M, 2))
        self.aux_dt = np.zeros((A, Ni))
        self.aux_acc = np.zeros((A, Ni + 1, 3))
        self.aux_gyr = np.zeros((A, Ni + 1, 3))
        self.aux_n = np.zeros(A, np.int64)
        self.aux_count = 0
        self._acc_dt = np.zeros(Ni)
        self._acc_acc = np.zeros((Ni + 1, 3))
        self._acc_gyr = np.zeros((Ni + 1, 3))
        self._acc_n = 0

        self.prior = Prior.empty(self.layout, self.dtype, self.device)
        self.db.clear()
        self._result_unread = False  # a dispatched step's result is abandoned

        self.last_p = np.zeros(3)
        self.last_cost = 0.0
        # pending relocalization match (setReloFrame, estimator.cpp:1128-1146),
        # consumed by the NEXT window solve as in-problem relo factors
        self._relo = None
        self._post_init_costs: list = []
        self.init_rejected_by_health = getattr(self, "init_rejected_by_health", 0)

    @property
    def prior(self) -> Prior:
        return self._prior

    @prior.setter
    def prior(self, p: Prior):
        """With the step graphed, the graphs read the prior at fixed
        addresses: a new prior is copied into them, not rebound."""
        if self._graph is None:
            self._prior = p
        else:
            self._graph.load_prior(p)

    # -------------------------------------------------------------------- IMU

    def process_imu(self, dt: float, acc, gyr):
        """Buffer one IMU sample into the open interval (estimator.cpp:
        84-118); the newest state is propagated once per frame."""
        acc = np.asarray(acc, float)
        gyr = np.asarray(gyr, float)
        if not self.first_imu:
            self.first_imu = True
            self.acc_prev, self.gyr_prev = acc, gyr

        j = min(self.frame_count, self.W)
        if self.frame_count != 0:
            k = j - 1
            n = self.imu_n[k]
            if n == 0:
                # interval opens with the previous boundary sample
                self.imu_acc[k, 0] = self.acc_prev
                self.imu_gyr[k, 0] = self.gyr_prev
            if n < self.N:
                self.imu_dt[k, n] = dt
                self.imu_acc[k, n + 1] = acc
                self.imu_gyr[k, n + 1] = gyr
                self.imu_n[k] = n + 1
            else:
                # one camera interval overflowed the static buffer: loud,
                # never silent (dropped samples corrupt preintegration)
                self.imu_overflow += 1
                if self.imu_overflow == 1:
                    warnings.warn(
                        f"IMU interval buffer overflow (N={self.N}); sample dropped — "
                        "raise imu_buf_len", RuntimeWarning)

            # all-frames init: accumulate the open published-frame interval
            if self.solver_flag == INITIAL:
                na = self._acc_n
                if na == 0:
                    self._acc_acc[0] = self.acc_prev
                    self._acc_gyr[0] = self.gyr_prev
                if na < self.Ni:
                    self._acc_dt[na] = dt
                    self._acc_acc[na + 1] = acc
                    self._acc_gyr[na + 1] = gyr
                    self._acc_n = na + 1

        self.acc_prev, self.gyr_prev = acc, gyr

    # ------------------------------------------------------------------ image

    def process_image(self, ids, pts, vels, uvs, t: float, toffs=0.0) -> dict:
        """One feature frame (estimator.cpp:120-217).  Returns a diagnostics
        dict with at least {"kind": ...}."""
        self._propagate_newest()
        col = min(self.frame_count, self.W)
        marg_old = self.db.add_frame(ids, pts, vels, uvs, toffs, col)
        marg_old = marg_old or self._overflow_guard()
        self.timestamps[col] = t
        if self.solver_flag == INITIAL:
            self._aux_append(ids, pts, t)

        if self.estimate_extrinsic == 2 and self.frame_count != 0:
            self._calibrate_extrinsic(col)

        if self.solver_flag == INITIAL:
            if self.frame_count == self.W:
                ok = False
                if self.estimate_extrinsic != 2 and t - self.initial_timestamp > 0.1:
                    ok = self._try_initialize()
                    self.initial_timestamp = t
                if ok:
                    self.solver_flag = NON_LINEAR
                    out = self._solve_and_slide(marg_old, failure_check=False)
                    out["kind"] = "initialized"
                    return out
                self._slide(marg_old)
                li = getattr(self, "last_init", None)
                return {"kind": "init_pending",
                        "reason": getattr(li, "reason", "waiting"),
                        "s_rel_sigma": getattr(li, "s_rel_sigma", 0.0)}
            # window still filling: next frame starts from this one's state
            self.frame_count += 1
            c = self.frame_count
            for a in (self.p, self.q, self.v, self.ba, self.bg):
                a[c] = a[c - 1]
            return {"kind": "filling", "frame_count": self.frame_count}

        out = self._solve_and_slide(marg_old, failure_check=True)
        out["kind"] = "vio" if out.get("ok", True) else "reboot"
        return out

    # --------------------------------------------------------------- internals

    def _propagate_newest(self):
        """Midpoint-propagate the newest window state over the open IMU
        interval, once per frame (estimator.cpp:107-114 does it per sample;
        the newest state is only read here, as the solve's initial guess)."""
        j = min(self.frame_count, self.W)
        if j == 0:
            return
        k = j - 1
        n = int(self.imu_n[k])
        if n == 0:
            return
        g = np.array([0.0, 0.0, self.cfg.g_norm])
        self.p[j], self.q[j], self.v[j] = midpoint_propagate_batch(
            self.p[j], self.q[j], self.v[j], self.ba[j], self.bg[j], g,
            self.imu_dt[k, :n], self.imu_acc[k, :n + 1], self.imu_gyr[k, :n + 1])

    @property
    def _np_dtype(self):
        return np.float32 if self.dtype == torch.float32 else np.float64

    def _adopt_state(self, s: WindowState):
        self.p, self.q, self.v = np.array(s.p), np.array(s.q), np.array(s.v)
        self.ba, self.bg = np.array(s.ba), np.array(s.bg)
        self.tic, self.qic = np.array(s.tic), np.array(s.qic)
        self.td = float(s.td)

    # ------------------------------------------------------- packed device IO

    def _blob_spec(self):
        """Shapes of every float field packed into the single upload blob, in
        order: one host→device copy per keyframe."""
        F, W, N, L = self.F, self.W, self.N, self.L
        return [
            ("p", (F, 3)), ("q", (F, 4)), ("v", (F, 3)), ("ba", (F, 3)),
            ("bg", (F, 3)), ("tic", (3,)), ("qic", (4,)), ("td", ()),
            ("imu_dt", (W, N)), ("imu_acc", (W, N + 1, 3)),
            ("imu_gyr", (W, N + 1, 3)), ("imu_mask", (W, N)),
            ("pt", (L, F, 2)), ("vel", (L, F, 2)), ("toff", (L, F)),
            ("valid", (L, F)), ("anchor", (L,)), ("inv_depth", (L,)),
            ("active", (L,)), ("needs_tri", (L,)),
            ("marg_old", ()), ("last_p", (3,)),
            # relocalization block (estimator.cpp:769-801): initial old-kf
            # body pose, per-slot old-kf observations, dynamic on/off gate
            ("relo_pq", (7,)), ("relo_pt", (L, 2)), ("relo_valid", (L,)),
            ("relo_on", ()),
        ]

    def _unpack(self, blob: torch.Tensor) -> dict:
        out = {}
        for (name, shp), o0, o1 in zip(self._blob_spec(), self._offs[:-1], self._offs[1:]):
            out[name] = blob[o0:o1].reshape(shp) if shp else blob[o0]
        return out

    def packed_step(self, blob: torch.Tensor, prior: Prior, marg_old: bool | None) -> StepResult:
        """The device step on an uploaded blob (and the device prior).  With
        `marg_old` None it is read from the blob as a bool tensor: both
        marginalizations run and one is kept (the batched step's form)."""
        f = self._unpack(blob)
        if marg_old is None:
            marg_old = f["marg_old"] > 0.5
        state = WindowState(p=f["p"], q=f["q"], v=f["v"], ba=f["ba"], bg=f["bg"],
                            tic=f["tic"], qic=f["qic"], td=f["td"])
        obs = FeatureObs(pt=f["pt"], vel=f["vel"], toff=f["toff"], valid=f["valid"] > 0.5,
                         anchor=f["anchor"].long(), inv_depth=f["inv_depth"],
                         active=f["active"] > 0.5)
        return self._step(state, f["imu_dt"], f["imu_acc"], f["imu_gyr"], f["imu_mask"] > 0.5,
                          obs, f["needs_tri"] > 0.5, prior, self.gravity, marg_old,
                          f["last_p"], f["relo_pq"][:3], f["relo_pq"][3:7], f["relo_pt"],
                          f["relo_valid"] > 0.5, f["relo_on"])

    def batched_step(self, inp: torch.Tensor, prior: Prior):
        """The step of S streams at once (the multi-stream pipeline's):
        `inp` [S, D+1] holds each stream's blob and, last, its selection
        flag; `prior` is the stacked prior.  `torch.func.vmap` of
        `packed_step` with `marg_old` read from each blob.  Returns (the
        packed results [S, R], the stacked prior with the new prior in the
        selected streams' slots and the old one elsewhere)."""
        blob, sel = inp[:, :-1], inp[:, -1] > 0.5

        def one(b, p):
            res = self.packed_step(b, p, None)
            return self._pack_result(res), res.prior

        out, new = torch.func.vmap(one)(blob, prior)
        return out, where_prior(sel, new, prior)

    def _stage(self, blob: np.ndarray):
        """Host half of the upload: the blob into the pinned buffer, once
        the previous upload has read it."""
        if self._pinned is None or self._pinned.numel() != blob.size:
            self._pinned = torch.empty(blob.size, dtype=self.dtype, pin_memory=True)
        elif self._upload_done is not None:
            self._upload_done.synchronize()
        self._pinned.numpy()[:] = blob

    def _copy_in(self, dst: torch.Tensor | None = None) -> torch.Tensor:
        """Device half of the upload: a non-blocking copy of the pinned
        buffer into `dst` (a new tensor if None); an event marks its end."""
        dst = torch.empty_like(self._pinned, device=self.device) if dst is None else dst
        dst.copy_(self._pinned, non_blocking=True)
        self._upload_done = torch.cuda.Event()
        self._upload_done.record()
        return dst

    def _result_spec(self):
        """(shape, is_bool) of each StepResult field packed into the result."""
        F, L = self.F, self.L
        return [((F, 3), False), ((F, 4), False), ((F, 3), False), ((F, 3), False),
                ((F, 3), False), ((3,), False), ((4,), False), ((), False), ((L,), False),
                ((), False), ((), False), ((), True), ((), True), ((3,), False), ((4,), False)]

    def _pack_result(self, res: StepResult) -> torch.Tensor:
        """Every field of a StepResult but the prior, in one flat tensor."""
        s = res.state
        fields = [s.p, s.q, s.v, s.ba, s.bg, s.tic, s.qic, s.td, res.inv_depth, res.cost0,
                  res.cost, res.fail_imu, res.fail_jump, res.relo_p, res.relo_q]
        return torch.cat([x.reshape(-1).to(self.dtype) for x in fields])

    def _unpack_result(self, flat: np.ndarray) -> StepResult:
        """A packed result (numpy) → StepResult with numpy fields (copies)
        and prior None."""
        out, o = [], 0
        for shp, is_bool in self._result_spec():
            n = int(np.prod(shp)) if shp else 1
            a = flat[o:o + n].reshape(shp).copy()
            out.append(a > 0.5 if is_bool else a)
            o += n
        st = WindowState(*out[:8])
        return StepResult(state=st, inv_depth=out[8], prior=None, cost0=out[9], cost=out[10],
                          fail_imu=out[11], fail_jump=out[12], relo_p=out[13], relo_q=out[14])

    def dispatch(self, blob: np.ndarray, marg_old: bool) -> PendingStep:
        """Upload the blob, run the step (a graph replay on CUDA), leave the
        new prior on the device and start the copy of the result to the
        host.  With `sync_check` on CUDA, from the upload to here runs under
        sync-debug mode "error"."""
        if self._result_unread:
            raise RuntimeError("the previous step's result was not completed")
        if self.device.type != "cuda":
            res = self.packed_step(torch.from_numpy(blob).to(self.device), self.prior, marg_old)
            self.prior = res.prior
            return PendingStep(self._pack_result(res), None, marg_old)

        self._stage(blob)
        graph = self._graph
        if graph is not None and not graph.captured:
            self._copy_in(graph.blob)
            graph.capture()  # synchronizes: outside the sync check
        check = self.sync_check
        if check:
            torch.cuda.set_sync_debug_mode("error")
        try:
            if graph is None:
                res = self.packed_step(self._copy_in(), self.prior, marg_old)
                self.prior = res.prior
                out = self._pack_result(res)
            else:
                self._copy_in(graph.blob)
                out = graph.replay(marg_old)
            if self._host_out is None:
                self._host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self._host_out.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        finally:
            if check:
                torch.cuda.set_sync_debug_mode("default")
        self._result_unread = True
        return PendingStep(self._host_out, event, marg_old)

    def fetch(self, pending: PendingStep) -> StepResult:
        """Wait for a dispatched step's result and unpack it."""
        if pending.event is not None:
            pending.event.synchronize()
        res = self._unpack_result(pending.host.numpy())
        self._result_unread = False
        return res

    def complete(self, pending: PendingStep, failure_check: bool) -> dict:
        """The host half of a dispatched step: fetch, then `post_step`."""
        return self.post_step(self.fetch(pending), pending.marg_old, failure_check)

    def _pack_blob(self, marg_old: bool) -> np.ndarray:
        dt = self._np_dtype
        db = self.db
        # pending relo match → per-slot observations + initial pose, gated on
        # its stamp still being inside the window (vector2double's
        # relo_frame_local_index search)
        relo_pq = np.array([0.0, 0, 0, 1, 0, 0, 0])  # [p(3), q_w-first(4)]
        relo_pt = np.zeros((self.L, 2))
        relo_valid = np.zeros(self.L)
        relo_on = 0.0
        if self._relo is not None:
            cols = np.nonzero(np.abs(self.timestamps - self._relo["stamp"]) < 1e-6)[0]
            if len(cols) == 0:
                self._relo = None
            else:
                col = int(cols[-1])
                self._relo["col"] = col
                relo_pq = np.concatenate([self.p[col], self.q[col]])
                relo_pt = self._relo["pt"]
                relo_valid = self._relo["valid"].astype(float)
                relo_on = 1.0
        fields = {
            "p": self.p, "q": self.q, "v": self.v, "ba": self.ba,
            "bg": self.bg, "tic": self.tic, "qic": self.qic, "td": self.td,
            "imu_dt": self.imu_dt, "imu_acc": self.imu_acc,
            "imu_gyr": self.imu_gyr, "imu_mask": self._imu_mask(),
            "pt": db.pt, "vel": db.vel, "toff": db.toff,
            "valid": db.valid, "anchor": db.anchor,
            "inv_depth": db.inv_depth, "active": db.active_mask(),
            "needs_tri": (db.inv_depth < 0) & db.active_mask(),
            "marg_old": float(marg_old), "last_p": self.last_p,
            "relo_pq": relo_pq, "relo_pt": relo_pt,
            "relo_valid": relo_valid, "relo_on": relo_on,
        }
        return np.concatenate([np.ravel(np.asarray(fields[name], dt))
                               for name, _ in self._blob_spec()])

    def _imu_mask(self):
        return np.arange(self.N)[None, :] < self.imu_n[:, None]

    def _aux_append(self, ids, pts, t: float):
        """Record a published frame + its inter-frame IMU interval in the
        all-frames init ring (all_image_frame insert, estimator.cpp:131-135)."""
        slot = self.aux_count % self.A
        ids = np.asarray(ids, np.int64)
        pts = np.asarray(pts, float)
        n = min(len(ids), self.cfg.max_cnt)
        self.aux_ids[slot] = -1
        self.aux_ids[slot, :n] = ids[:n]
        self.aux_pt[slot] = 0.0
        self.aux_pt[slot, :n] = pts[:n, :2]
        self.aux_t[slot] = t
        self.aux_dt[slot] = self._acc_dt
        self.aux_acc[slot] = self._acc_acc
        self.aux_gyr[slot] = self._acc_gyr
        self.aux_n[slot] = self._acc_n
        self.aux_count += 1
        self._acc_n = 0

    def _overflow_guard(self) -> bool:
        """Force MARGIN_OLD when MARGIN_SECOND_NEW's interval merge
        (slideWindow :1070-1097) would overflow the static IMU buffer."""
        if self.frame_count < self.W:
            return False
        return int(self.imu_n[self.W - 2] + self.imu_n[self.W - 1]) > self.N

    def pre_step(self, ids, pts, vels, uvs, t: float, toffs=0.0):
        """Host half of a NON_LINEAR frame BEFORE the device solve:
        propagation, feature-DB insert + keyframe decision, blob packing.
        Returns (blob, marg_old); the fetched result goes to `post_step`."""
        self._propagate_newest()
        col = min(self.frame_count, self.W)
        marg_old = self.db.add_frame(ids, pts, vels, uvs, toffs, col)
        marg_old = marg_old or self._overflow_guard()
        self.timestamps[col] = t
        return self._pack_blob(marg_old), marg_old

    def dispatch_step(self, ids, pts, vels, uvs, t: float, toffs=0.0) -> PendingStep:
        """A NON_LINEAR frame up to the device step: `pre_step`, then
        `dispatch`; `complete` finishes it."""
        return self.dispatch(*self.pre_step(ids, pts, vels, uvs, t, toffs=toffs))

    def _solve_and_slide(self, marg_old: bool, failure_check: bool) -> dict:
        return self.complete(self.dispatch(self._pack_blob(marg_old), marg_old), failure_check)

    def post_step(self, res: StepResult, marg_old: bool, failure_check: bool) -> dict:
        """Host half AFTER the device solve (`res` fetched; the new prior is
        already on the device)."""
        if failure_check:
            few_feats = self.db.count_tracked(self.F - 1) < 2
            if bool(res.fail_imu) or bool(res.fail_jump) or few_feats:
                self.failures += 1
                self.clear_state()
                return {"ok": False, "reason": "failure detection"}
            if not self._init_health_check(float(res.cost)):
                self.failures += 1
                self.init_rejected_by_health += 1
                self.clear_state()
                return {"ok": False, "reason": "bad init (cost health)"}

        self._adopt_state(res.state)
        self.db.remove_failures(np.asarray(res.inv_depth))
        self.last_cost = float(res.cost)
        relo_out = self._relo_result(res)  # pre-slide frame indexing
        self._slide(marg_old)
        self.last_p = self.p[self.W].copy()
        out = {"ok": True, "marg_old": bool(marg_old), "cost": self.last_cost}
        if relo_out is not None:
            out["relo"] = relo_out
        return out

    # post-init health monitor: the whitened window cost of a converged
    # healthy window sits around 1e2-1e3 on the proxy; a mis-scaled init
    # stays orders of magnitude above that for many frames
    INIT_HEALTH_FRAMES = 12   # monitor the first N post-init solves
    INIT_HEALTH_SKIP = 4      # ignore the first few (re-triangulation settling)
    INIT_COST_MAX = 1.0e5     # median cost above this ⇒ reboot + re-init

    def _init_health_check(self, cost: float) -> bool:
        """Post-init scale/consistency guard: a persistently pathological
        median cost over the first solves after init means the
        initialization was bad → reboot and retry (clearState)."""
        c = self._post_init_costs
        if len(c) >= self.INIT_HEALTH_FRAMES:
            return True
        c.append(cost)
        if len(c) == self.INIT_HEALTH_FRAMES:
            return float(np.median(c[self.INIT_HEALTH_SKIP:])) < self.INIT_COST_MAX
        return True

    def _slide(self, marg_old: bool):
        """slideWindow (estimator.cpp:1005-1126) on the host buffers; the
        prior was already produced by the device step (or is invalid during
        INITIAL)."""
        F, W = self.F, self.W
        if marg_old:
            # re-anchor depths using pre-slide camera poses of frames 0, 1
            R0, R1 = nplie.q2R(self.q[0]), nplie.q2R(self.q[1])
            Ric = nplie.q2R(self.qic)
            self.db.slide_old(self.p[0] + R0 @ self.tic, R0 @ Ric,
                              self.p[1] + R1 @ self.tic, R1 @ Ric)
            for a in (self.p, self.q, self.v, self.ba, self.bg, self.timestamps):
                a[:-1] = a[1:]
            # the newest slot keeps its value (the reference's swap leaves
            # Ps[W] == old Ps[W]; propagation continues from it)
            self.imu_dt[:-1] = self.imu_dt[1:]
            self.imu_acc[:-1] = self.imu_acc[1:]
            self.imu_gyr[:-1] = self.imu_gyr[1:]
            self.imu_n[:-1] = self.imu_n[1:]
            self._reset_interval(W - 1)
        else:
            # merge the newest interval into the previous one (:1070-1097)
            self.db.slide_new()
            k_dst, k_src = W - 2, W - 1
            n0, n1 = int(self.imu_n[k_dst]), int(self.imu_n[k_src])
            take = min(n1, self.N - n0)
            if take < n1:  # unreachable with _overflow_guard; never silent
                self.imu_overflow += n1 - take
                warnings.warn("IMU merge truncation despite overflow guard", RuntimeWarning)
            if take > 0:
                self.imu_dt[k_dst, n0:n0 + take] = self.imu_dt[k_src, :take]
                self.imu_acc[k_dst, n0 + 1:n0 + take + 1] = self.imu_acc[k_src, 1:take + 1]
                self.imu_gyr[k_dst, n0 + 1:n0 + take + 1] = self.imu_gyr[k_src, 1:take + 1]
                self.imu_n[k_dst] = n0 + take
            self._reset_interval(k_src)
            for a in (self.p, self.q, self.v, self.ba, self.bg, self.timestamps):
                a[F - 2] = a[F - 1]

    def _reset_interval(self, k: int):
        self.imu_n[k] = 0
        self.imu_dt[k] = 0
        self.imu_acc[k] = 0
        self.imu_gyr[k] = 0

    def _try_initialize(self) -> bool:
        res = self.initializer.try_initialize(
            self.db, self.imu_dt, self.imu_acc, self.imu_gyr, self.imu_n,
            self.qic, self.tic, est=self, win_ts=self.timestamps)
        self.last_init = res
        if not res.ok:
            return False
        self.p, self.q, self.v = res.p.copy(), res.q.copy(), res.v.copy()
        self.ba = np.zeros((self.F, 3))
        self.bg = np.tile(res.bg[None], (self.F, 1))
        # depths are invalid across the rescale — re-triangulated in the step
        self.db.inv_depth[:] = -1.0
        self.last_p = self.p[self.W].copy()
        return True

    def set_relo_frame(self, stamp: float, match_ids, match_pts_norm):
        """Fast relocalization (Estimator::setReloFrame, estimator.cpp:
        1128-1146): record a loop match — feature ids and their normalized
        coordinates in the OLD keyframe.  The next window solve adds the relo
        pose as a free block; its refined relative pose comes back in that
        solve's event as ev["relo"].  Returns {"pending": True, ...} when
        armed, None otherwise."""
        if self.solver_flag != NON_LINEAR:
            return None
        if not np.any(np.abs(self.timestamps - stamp) < 1e-6):
            return None
        slot_of = {int(i): k for k, i in enumerate(self.db.ids) if i >= 0}
        pt = np.zeros((self.L, 2))
        valid = np.zeros(self.L, bool)
        n = 0
        for fid, p2 in zip(np.asarray(match_ids), np.asarray(match_pts_norm)):
            k = slot_of.get(int(fid))
            if k is None or self.db.inv_depth[k] <= 0:
                continue
            pt[k] = p2[:2]
            valid[k] = True
            n += 1
        if n < 12:
            return None
        self._relo = {"stamp": float(stamp), "pt": pt, "valid": valid, "col": -1, "n": n}
        return {"pending": True, "n_matches": n}

    def _relo_result(self, res: StepResult) -> dict | None:
        """Refined relative pose from a solve that consumed the pending relo
        match (double2vector's relo tail, estimator.cpp:597-618)."""
        if self._relo is None or self._relo.get("col", -1) < 0 or res.relo_p is None:
            return None
        col = self._relo["col"]
        rel_t, rel_q, rel_yaw = relative_pose_4dof(
            np.asarray(res.relo_p), np.asarray(res.relo_q),
            np.asarray(res.state.p[col]), np.asarray(res.state.q[col]))
        self._relo = None
        return {"ok": True, "rel_t": rel_t, "rel_q": rel_q, "rel_yaw": float(rel_yaw)}

    def _calibrate_extrinsic(self, col: int):
        """ESTIMATE_EXTRINSIC == 2 (estimator.cpp:140-156): feed the
        camera/IMU pair rotations of (col-1, col); accept once excited."""
        both = self.db.used & self.db.valid[:, col - 1] & self.db.valid[:, col]
        if both.sum() < 9:
            return
        # camera rotation from the essential solve between the two frames
        t = lambda a: torch.as_tensor(a, dtype=self.dtype).to(self.device)  # noqa: E731
        rel = solve_relative_pose(t(self.db.pt[:, col - 1]), t(self.db.pt[:, col]),
                                  torch.as_tensor(both).to(self.device),
                                  self.ex_gumbel((N_HYP, self.L), self.frame_count).to(self.device),
                                  min_corres=9, min_inliers=8)
        if not bool(rel.ok):
            return
        q_cam = nplie.R2q(rel.R.cpu().numpy())
        # IMU rotation over the interval at the current gyro bias
        k = min(col, self.W) - 1
        n = int(self.imu_n[k])
        if n == 0:
            return
        q_imu = np.array([1.0, 0, 0, 0])
        for i in range(n):
            w = 0.5 * (self.imu_gyr[k, i] + self.imu_gyr[k, i + 1]) - self.bg[col]
            q_imu = nplie.qmul(q_imu, nplie.deltaQ(w * self.imu_dt[k, i]))
        self._ex_buf = push_pair(self._ex_buf, t(q_cam), t(nplie.qnormalize(q_imu)))
        q_ic, ok, self._ex_buf = calibrate_ex_rotation(self._ex_buf)
        if bool(ok):
            self.qic = q_ic.cpu().numpy()
            self.estimate_extrinsic = 1


class BatchedStep:
    """The VIO step of S lock-step streams on one device program: the host
    half of `Estimator.batched_step`, over a stacked prior that stays on the
    device.  `dispatch` uploads the S blobs and the selection in one copy,
    runs the step (one CUDA graph replay on CUDA, captured on the first
    dispatch) and starts the copy of the results to the host; `fetch` waits
    for it.  With `sync_check` on CUDA, from the upload to the start of the
    result copy runs under sync-debug mode "error".  On the CPU the step
    runs eagerly."""

    def __init__(self, est: Estimator, S: int):
        self.est, self.S = est, S
        self.device, self.dtype = est.device, est.dtype
        self.sync_check = False
        empty = Prior.empty(est.layout, est.dtype, est.device)
        self._graph = (BatchStepGraph(est.batched_step, S, est._offs[-1], empty)
                       if self.device.type == "cuda" else None)
        self.prior = self._graph.prior if self._graph is not None else stack_priors([empty] * S)
        self._pinned = None
        self._upload_done = None
        self._host_out = None
        self.dispatches = 0

    @property
    def replays(self) -> int:
        return 0 if self._graph is None else self._graph.replays

    @property
    def captures(self) -> int:
        return 0 if self._graph is None else self._graph.captures

    def set_prior(self, s: int, prior: Prior) -> None:
        """Stream s's slot of the stacked prior ← prior, in place."""
        copy_prior(slot_prior(self.prior, s), prior)

    def dispatch(self, blobs: np.ndarray, sel: np.ndarray) -> PendingStep:
        """blobs [S, D] (zeros in the slots of streams outside the batch),
        sel [S] bool: the streams whose prior slot takes the new prior."""
        inp = np.concatenate([blobs, np.asarray(sel, blobs.dtype)[:, None]], axis=1)
        self.dispatches += 1
        if self.device.type != "cuda":
            out, self.prior = self.est.batched_step(
                torch.from_numpy(inp).to(self.device, self.dtype), self.prior)
            return PendingStep(out, None, False)
        if self._pinned is None:
            self._pinned = torch.empty(inp.shape, dtype=self.dtype, pin_memory=True)
        elif self._upload_done is not None:
            self._upload_done.synchronize()
        self._pinned.numpy()[:] = inp
        graph = self._graph
        if graph.graph is None:
            graph.inp.copy_(self._pinned, non_blocking=True)
            graph.capture()  # synchronizes: outside the sync check
        check = self.sync_check
        if check:
            torch.cuda.set_sync_debug_mode("error")
        try:
            graph.inp.copy_(self._pinned, non_blocking=True)
            self._upload_done = torch.cuda.Event()
            self._upload_done.record()
            out = graph.replay()
            if self._host_out is None:
                self._host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self._host_out.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        finally:
            if check:
                torch.cuda.set_sync_debug_mode("default")
        return PendingStep(self._host_out, event, False)

    def fetch(self, pending: PendingStep) -> list:
        """Wait for a dispatched step's results: one StepResult (numpy
        fields, prior None) per stream."""
        if pending.event is not None:
            pending.event.synchronize()
        flat = pending.host.numpy()
        return [self.est._unpack_result(flat[s]) for s in range(self.S)]
