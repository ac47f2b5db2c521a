"""Keyframe database and global pose graph (host orchestration).

PyTorch counterpart of `vins_tpu/loop/pose_graph.py`, the reference's
pose_graph/src/{keyframe.cpp, pose_graph.cpp}:

  * `KeyFrame`: VIO pose, window landmarks, BRIEF descriptors of the tracked
    window points and of fresh FAST corners (keyframe.cpp:75-113);
  * `PoseGraph.add_keyframe`: sequence shift → retrieval query (detectLoop,
    pose_graph.cpp:304-386) → descriptor matching and PnP-RANSAC
    (findConnection, keyframe.cpp:259-520) → throttled 4-DoF solve
    (optimize4DoF, :403-579) → drift update and re-mapping;
  * map merge: the first loop from a new sequence onto another computes a
    yaw + translation shift of the whole sequence (:103-124);
  * save/load: an npz map that the JAX package's `PoseGraph` reads and
    writes too (the reference's pose_graph.txt and descriptor dumps,
    :697-870).

The graph's bookkeeping is host numpy; the descriptors live on the device.
Per `add_keyframe` the host waits on the device once for the query's
scores, once per verified candidate (the whole match → PnP → gate chain is
one upload, device work with no sync, and one fetch) and once per 4-DoF
solve (one upload of the active slice, one fetch of its result).  Solves run
over the active slice [earliest loop, current] padded to a power of two ≥
64 slots (pose_graph.cpp:450-477 optimizes the same range), at most once per
`opt_interval_s` of stream time (the reference's 2 s optimize thread), with
pending loops batched into the next solve; `flush()` forces it.  A loaded
map (sequence 0) is pinned in every solve and its keyframes' poses are never
written back, so they stay bitwise as loaded.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..core import nplie
from ..frontend.tracker import gumbel_draw
from .brief import brief_describe, fast_detect, match_descriptors, smooth_for_brief
from .optimize4dof import GraphArrays, optimize_4dof
from .retrieval import KeyframeDB, pick_loop_candidate
from .verify import make_verify_connection

N_HYP = 128  # PnP-RANSAC hypotheses per verification (vins_tpu/loop/verify.py:48)


def _ypr(q):
    return nplie.R2ypr(nplie.q2R(q))


def _yawR(yaw_deg):
    return nplie.ypr2R(np.array([float(yaw_deg), 0.0, 0.0]))


def _upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host → device copy that does not wait for the device: from pinned
    memory, asynchronous, on CUDA."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class KeyFrame:
    def __init__(self, index, stamp, p_vio, q_vio, points_3d, points_2d_norm,
                 window_desc, window_valid, fast_pts_norm, fast_desc, fast_valid,
                 sequence=1, point_ids=None, window_uv=None, image=None,
                 fast_3d=None, fast_3d_valid=None):
        self.index = index
        self.stamp = stamp
        self.sequence = sequence
        self.p_vio = np.array(p_vio, float)  # body in world (shifted)
        self.q_vio = np.array(q_vio, float)
        self.p = self.p_vio.copy()  # pose-graph corrected
        self.q = self.q_vio.copy()
        self.points_3d = np.array(points_3d, float)  # [Lw,3] world
        self.points_2d = np.array(points_2d_norm, float)  # [Lw,2]
        # estimator feature ids of the window points (the id channel of the
        # reference's match_points message, for fast relocalization)
        self.point_ids = (np.full(len(self.points_3d), -1, np.int64)
                          if point_ids is None else np.asarray(point_ids, np.int64))
        self.window_desc = window_desc  # [Lw,256] ±1, device
        self.window_valid = window_valid  # [Lw], device
        self.fast_pts = fast_pts_norm  # [P,2] normalized coordinates, device
        self.fast_desc = fast_desc  # [P,256], device
        self.fast_valid = fast_valid  # [P], device
        # two-view-triangulated world points of the FAST corners (host), so
        # that verification runs corner to corner
        self.fast_3d = fast_3d  # [P,3] or None
        self.fast_3d_valid = fast_3d_valid  # [P] bool or None
        self.window_uv = None if window_uv is None else np.asarray(window_uv, float)
        self.image = image
        self.loop_index = -1
        self.loop_rel_t = np.zeros(3)
        self.loop_rel_q = np.array([1.0, 0, 0, 0])
        self.loop_rel_yaw = 0.0


def extract_keyframe_features(img: torch.Tensor, cam, max_fast: int = 256,
                              fast_thresh: float = 20.0):
    """FAST + BRIEF for a new keyframe (computeBRIEFPoint, keyframe.cpp:
    87-113).  Returns (pts_norm [P,2], desc [P,256], valid [P])."""
    im = img.to(torch.float32)
    pts, ok = fast_detect(im, max_pts=max_fast, threshold=fast_thresh)
    desc = brief_describe(smooth_for_brief(im), pts)
    rays = cam.lift(pts)
    return rays[..., :2] / rays[..., 2:3], desc, ok


def describe_window_points(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """BRIEF at the tracked window points (computeWindowBRIEFPoint,
    keyframe.cpp:75-85); uv [Lw,2] pixels."""
    return brief_describe(smooth_for_brief(img.to(torch.float32)), uv.to(torch.float32))


class HostGraph:
    """Host (numpy) copies of the pose-graph tensors, updated per keyframe
    by array stores and uploaded once per 4-DoF solve."""

    def __init__(self, capacity: int):
        self.K = capacity
        self.t_vio = np.zeros((capacity, 3))
        self.ypr_vio = np.zeros((capacity, 3))
        self.yaw = np.zeros(capacity)
        self.t = np.zeros((capacity, 3))
        self.loop_to = np.full(capacity, -1, np.int32)
        self.loop_t = np.zeros((capacity, 3))
        self.loop_yaw = np.zeros(capacity)
        self.used = np.zeros(capacity, bool)
        # map sequence per keyframe: sequence 0 = a loaded base map, held
        # constant in every 4-DoF solve (pose_graph.cpp:473-476)
        self.sequence = np.ones(capacity, np.int32)

    def grow(self):
        K = self.K
        self.K = 2 * K

        def pad(a):
            return np.concatenate([a, np.zeros_like(a)], axis=0)

        self.t_vio = pad(self.t_vio)
        self.ypr_vio = pad(self.ypr_vio)
        self.yaw = pad(self.yaw)
        self.t = pad(self.t)
        self.loop_to = np.concatenate([self.loop_to, np.full(K, -1, np.int32)])
        self.loop_t = pad(self.loop_t)
        self.loop_yaw = pad(self.loop_yaw)
        self.used = pad(self.used)
        self.sequence = np.concatenate([self.sequence, np.ones(K, np.int32)])


class PoseGraph:
    def __init__(self, qic, tic, capacity: int = 512, db: KeyframeDB | None = None,
                 min_loop_inliers: int = 25, exclude_last: int = 50,
                 opt_interval_s: float = 0.0, device="cuda", gumbel=None):
        """`gumbel(shape)` gives the standard Gumbel draws [128, N] of one
        verification's RANSAC (a tensor or an array); by default a seeded
        generator on the device."""
        self.device = torch.device(device)
        self.qic = np.array(qic, float)
        self.tic = np.array(tic, float)
        self.keyframes: list[KeyFrame] = []
        self.db = db or KeyframeDB(capacity_round(capacity), 256, device=self.device)
        self.min_loop_inliers = min_loop_inliers
        self.exclude_last = exclude_last  # detectLoop skips recent frames (pose_graph.cpp:319)
        # drift correction (VIO → corrected) as one tuple swapped whole, and
        # the sequence-merge shifts
        self._drift = (np.eye(3), np.zeros(3))
        self.seq_shift = {0: (np.eye(3), np.zeros(3))}  # seq → (R, t) VIO shift
        self._merged: set = set()
        self.earliest_loop_index = -1
        self._gen = None
        self.gumbel = gumbel if gumbel is not None else self._draw_gumbel
        self._verify = make_verify_connection(min_loop_inliers)
        self.graph = HostGraph(capacity_round(capacity))
        self.opt_interval_s = opt_interval_s
        self._opt_pending = False
        self._last_opt_stamp = -np.inf
        self.n_optimizes = 0
        self.last_match = None
        # add_keyframe / flush may run on a worker thread while
        # update_keyframe_loop runs on the frame loop: all graph mutation is
        # serialized here (the reference's mutexes, pose_graph.h:66-69);
        # correct_pose only reads the drift tuple
        self._lock = threading.RLock()

    def _draw_gumbel(self, shape):
        if self._gen is None:
            self._gen = torch.Generator(device=self.device).manual_seed(11)
        return gumbel_draw(shape, self._gen, self.device)

    @property
    def r_drift(self):
        return self._drift[0]

    @property
    def t_drift(self):
        return self._drift[1]

    # ------------------------------------------------------------------ add

    def add_keyframe(self, kf: KeyFrame, detect_loop: bool = True) -> dict:
        with self._lock:
            return self._add_keyframe_locked(kf, detect_loop)

    def _add_keyframe_locked(self, kf: KeyFrame, detect_loop: bool) -> dict:
        # sequence shift (pose_graph.cpp:53-60)
        if kf.sequence not in self.seq_shift:
            self.seq_shift[kf.sequence] = (np.eye(3), np.zeros(3))
        Rs, ts = self.seq_shift[kf.sequence]
        r_drift, t_drift = self._drift
        kf.p_vio = Rs @ kf.p_vio + ts
        kf.q_vio = nplie.qmul(nplie.R2q(Rs), kf.q_vio)
        kf.p = r_drift @ kf.p_vio + t_drift
        kf.q = nplie.qmul(nplie.R2q(r_drift), kf.q_vio)

        i = len(self.keyframes)
        kf.index = i
        if i >= self.graph.K:
            self.graph.grow()
        self.keyframes.append(kf)
        g = self.graph
        g.t_vio[i] = kf.p_vio
        g.ypr_vio[i] = _ypr(kf.q_vio)
        g.yaw[i] = _ypr(kf.q)[0]
        g.t[i] = kf.p
        g.used[i] = True
        g.sequence[i] = kf.sequence

        out = {"index": i, "loop": None}
        cand = None
        if detect_loop:
            idx, scores = self.db.query(kf.fast_desc, kf.fast_valid,
                                        exclude_last=self.exclude_last, newest_kf=kf.index)
            cand = pick_loop_candidate(idx, scores)
            out["scores"] = scores
            out["score_idx"] = idx
            out["candidate"] = cand
        self.db.add(kf.fast_desc, kf.fast_valid, kf_index=kf.index)
        if cand is not None:
            ok, why = self._find_connection(kf, int(cand))
            out["verify"] = why
            if ok:
                out["loop"] = int(cand)
                self._opt_pending = True
        # throttled 4-DoF solve (the reference's 2 s optimize thread drains
        # optimize_buf and solves, pose_graph.cpp:403-416)
        if self._opt_pending and kf.stamp - self._last_opt_stamp >= self.opt_interval_s:
            self._run_optimize(kf.stamp)
        return out

    def flush(self):
        """Force the pending 4-DoF solve (end of stream, tests)."""
        with self._lock:
            if self._opt_pending and self.keyframes:
                self._run_optimize(self.keyframes[-1].stamp)

    def _run_optimize(self, stamp: float):
        # the drift anchor is a current-session keyframe: the loaded map's
        # keyframes carry stored loop edges but are pinned
        cur = max((k.index for k in self.keyframes if k.loop_index >= 0 and k.sequence != 0),
                  default=-1)
        if cur < 0:
            self._opt_pending = False
            return
        self._optimize(cur)
        self._opt_pending = False
        self._last_opt_stamp = stamp

    # ------------------------------------------------------- loop validation

    def _verify_candidate(self, kf: KeyFrame, old: KeyFrame) -> dict:
        """The device half of findConnection: one upload, the match →
        PnP-RANSAC → relative gate chain with no host sync, one fetch.  The
        keyframe's own FAST corners with their two-view depth are matched
        against the old corners (more precise than the tracked window
        points, whose positions drift off the corner peaks); without corner
        depth the window landmarks are used."""
        use_fast3d = kf.fast_3d is not None and kf.fast_3d_valid is not None
        if use_fast3d:
            q_desc, base_valid = kf.fast_desc, kf.fast_valid
            X_np = np.asarray(kf.fast_3d, float)
            extra_valid = np.asarray(kf.fast_3d_valid, bool)
        else:
            q_desc, base_valid = kf.window_desc, kf.window_valid
            X_np = np.asarray(kf.points_3d, float)
            extra_valid = np.ones(len(X_np), bool)
        N = len(X_np)

        # initial guess: the current keyframe's CAMERA pose from VIO
        p_c0 = kf.p_vio + nplie.q2R(kf.q_vio) @ self.tic
        q_c0 = nplie.qmul(kf.q_vio, self.qic)
        dev = _upload(np.concatenate([X_np.reshape(-1), extra_valid.astype(float), p_c0, q_c0,
                                      self.qic, self.tic, kf.p_vio, kf.q_vio]), self.device)
        X = dev[:3 * N].reshape(N, 3)
        q_valid = base_valid & (dev[3 * N:4 * N] > 0.5)
        p_c0_d, q_c0_d, qic, tic, p_cur, q_cur = torch.split(dev[4 * N:], [3, 4, 4, 3, 3, 4])
        gumbel = self.gumbel((N_HYP, N))
        if not torch.is_tensor(gumbel):
            gumbel = torch.from_numpy(np.array(gumbel, np.float32))
        gumbel = gumbel.to(device=self.device, dtype=torch.float32)
        v = self._verify(q_desc, q_valid, X, old.fast_desc, old.fast_valid, old.fast_pts,
                         p_c0_d, q_c0_d, qic, tic, p_cur, q_cur, gumbel)
        parts = [torch.stack([x.to(torch.float64) for x in (
                     v["n_matches"], torch.sum(q_valid), v["pnp_ok"], v["n_inliers"],
                     v["rel_ok"])]),
                 v["rel_t"], v["rel_yaw"][None], v["q_old_b"], v["inliers"],
                 old.fast_pts[v["midx"]]]
        if use_fast3d:
            # the fast-relocalization payload pairs (estimator feature id,
            # old keyframe point): FAST corners and tracked landmarks rarely
            # coincide, so it uses the reference's own pairing, the window
            # descriptors (which carry the ids) against the old corners
            # (searchByBRIEFDes, keyframe.cpp:152-171)
            widx, wok = match_descriptors(kf.window_desc, kf.window_valid, old.fast_desc,
                                          old.fast_valid)
            parts += [wok, old.fast_pts[widx]]
        h = torch.cat([p.to(torch.float64).reshape(-1) for p in parts]).cpu().numpy()  # one fetch
        out = dict(zip(("n_matches", "n_query", "pnp_ok", "n_inliers", "rel_ok"),
                       (int(x) for x in h[:5])))
        out.update(rel_t=h[5:8], rel_yaw=float(h[8]), q_old_b=h[9:13],
                   inliers=h[13:13 + N] > 0.5, pts_old=h[13 + N:13 + 3 * N].reshape(N, 2))
        if use_fast3d:
            Lw = len(kf.window_valid)
            out.update(window_ok=h[13 + 3 * N:13 + 3 * N + Lw] > 0.5,
                       window_pts_old=h[13 + 3 * N + Lw:].reshape(Lw, 2))
        return out

    def _find_connection(self, kf: KeyFrame, old_idx: int):
        """findConnection (keyframe.cpp:259-520): descriptor matching, then
        PnP-RANSAC on (current 3D, old 2D) (`_verify_candidate`), then the
        loop edge and, for a first loop onto another sequence, the merge.
        Returns (ok, the rejecting gate or "ok")."""
        old = self.keyframes[old_idx]
        v = self._verify_candidate(kf, old)
        if v["n_matches"] < self.min_loop_inliers:
            return False, f"desc_matches={v['n_matches']}/{v['n_query']}"
        if not v["pnp_ok"]:
            return False, f"pnp_inliers={v['n_inliers']}"
        if not v["rel_ok"]:
            return False, (f"relative_check dt={np.round(v['rel_t'], 2)}"
                           f" dyaw={v['rel_yaw']:.1f}")
        rel_t, rel_yaw, q_old_b = v["rel_t"], v["rel_yaw"], v["q_old_b"]
        if "window_ok" in v:
            sel = v["window_ok"] & (kf.point_ids >= 0)
            ids, pts = kf.point_ids[sel], v["window_pts_old"][sel]
        else:
            ids, pts = kf.point_ids[v["inliers"]], v["pts_old"][v["inliers"]]
        self.last_match = {"kf_index": kf.index, "stamp": kf.stamp, "old_index": old_idx,
                           "ids": ids, "pts_old": pts}

        kf.loop_index = old_idx
        kf.loop_rel_t = np.array(rel_t)
        kf.loop_rel_yaw = rel_yaw
        kf.loop_rel_q = nplie.qmul(nplie.qconj(q_old_b), kf.q_vio)
        g = self.graph
        g.loop_to[kf.index] = old_idx
        g.loop_t[kf.index] = kf.loop_rel_t
        g.loop_yaw[kf.index] = kf.loop_rel_yaw
        if self.earliest_loop_index < 0 or old_idx < self.earliest_loop_index:
            self.earliest_loop_index = old_idx

        # map merge: the first loop from a sequence onto another
        # (pose_graph.cpp:103-124)
        if kf.sequence != old.sequence and kf.sequence not in self._merged:
            self._merge_sequences(kf, old)
        return True, "ok"

    def _merge_sequences(self, kf: KeyFrame, old: KeyFrame):
        """The yaw + t shift that maps kf's sequence onto old's world."""
        w_P_cur = old.p + nplie.q2R(old.q) @ kf.loop_rel_t
        yaw_shift = _ypr(old.q)[0] + kf.loop_rel_yaw - _ypr(kf.q_vio)[0]
        Rsh = _yawR(yaw_shift)
        tsh = w_P_cur - Rsh @ kf.p_vio
        self.seq_shift[kf.sequence] = (Rsh, tsh)
        self._merged.add(kf.sequence)
        # re-shift every stored keyframe of the sequence, this one included
        g = self.graph
        for k in self.keyframes:
            if k.sequence == kf.sequence:
                k.p_vio = Rsh @ k.p_vio + tsh
                k.q_vio = nplie.qmul(nplie.R2q(Rsh), k.q_vio)
                g.t_vio[k.index] = k.p_vio
                g.ypr_vio[k.index] = _ypr(k.q_vio)

    # ---------------------------------------------------------------- solve

    def _optimize(self, cur: int):
        """One 4-DoF solve over the active slice [earliest loop, cur]
        (pose_graph.cpp:450-477), padded to a power of two ≥ 64 slots; one
        upload, one fetch; write-back and drift update in numpy."""
        g = self.graph
        base = max(self.earliest_loop_index, 0)
        n = cur + 1 - base
        size = 64
        while size < n:
            size *= 2
        sl = slice(base, cur + 1)
        # gauge: the earliest looped keyframe, and every base-map
        # (sequence-0) keyframe: a loaded map is immutable (:473-476)
        fixed = np.zeros(n, bool)
        fixed[0] = True
        fixed |= g.sequence[sl] == 0
        loop_to = np.where(g.loop_to[sl] >= 0, g.loop_to[sl] - base, -1)  # loops point ≥ base
        host = np.zeros((size, 17))
        host[:, 10] = -1.0
        host[:n] = np.concatenate([
            g.t_vio[sl], g.ypr_vio[sl], g.yaw[sl, None], g.t[sl], loop_to[:, None],
            g.loop_t[sl], g.loop_yaw[sl, None], g.used[sl, None], fixed[:, None]], axis=1)
        d = _upload(host, self.device)
        dev = GraphArrays(t_vio=d[:, 0:3], ypr_vio=d[:, 3:6], yaw=d[:, 6], t=d[:, 7:10],
                          loop_to=d[:, 10].round().long(), loop_t=d[:, 11:14], loop_yaw=d[:, 14],
                          used=d[:, 15] > 0.5, fixed=d[:, 16] > 0.5)
        solved = optimize_4dof(dev, iters=5)
        res = torch.cat([solved.yaw[:, None], solved.t], dim=1).cpu().numpy()  # one fetch
        yaw, t = res[:n, 0], res[:n, 1:]
        g.yaw[sl] = yaw
        g.t[sl] = t
        self.n_optimizes += 1

        # drift at cur (pose_graph.cpp:549-557)
        yaw_drift = nplie.normalize_angle(g.yaw[cur] - g.ypr_vio[cur, 0])
        R_drift = _yawR(yaw_drift)
        t_drift = g.t[cur] - R_drift @ g.t_vio[cur]
        self._drift = (R_drift, t_drift)

        # write-back of the optimized poses ≤ cur (the pinned base map's
        # stay as loaded) …
        ypr_v = g.ypr_vio[sl]
        qs = nplie.R2q(nplie.ypr2R(np.stack([yaw, ypr_v[:, 1], ypr_v[:, 2]], axis=-1)))
        for off, k in enumerate(self.keyframes[sl]):
            if k.sequence != 0:
                k.p = t[off]
                k.q = qs[off]
        # … and drift-corrected poses after cur (:562-571); base-map
        # keyframes are never dragged by drift
        tail = [k for k in self.keyframes[cur + 1:] if k.sequence != 0]
        if tail:
            p_new = np.stack([k.p_vio for k in tail]) @ R_drift.T + t_drift
            q_new = nplie.qmul(nplie.R2q(R_drift)[None], np.stack([k.q_vio for k in tail]))
            for off, k in enumerate(tail):
                k.p = p_new[off]
                k.q = q_new[off]
                g.t[k.index] = p_new[off]
                g.yaw[k.index] = _ypr(q_new[off])[0]

    def update_keyframe_loop(self, index: int, rel_t, rel_q, rel_yaw: float):
        """Adopt a BA-refined loop edge from the estimator's fast
        relocalization (updateKeyFrameLoop, pose_graph.cpp:889-923): replace
        the keyframe's loop edge and update the drift at once."""
        with self._lock:
            kf = self.keyframes[index]
            if kf.loop_index < 0:
                return False
            if abs(rel_yaw) > 30.0 or np.linalg.norm(rel_t) > 20.0:
                return False  # the reference's sanity gate (:897-899)
            kf.loop_rel_t = np.asarray(rel_t, float)
            kf.loop_rel_q = np.asarray(rel_q, float)
            kf.loop_rel_yaw = float(rel_yaw)
            g = self.graph
            g.loop_to[index] = kf.loop_index
            g.loop_t[index] = kf.loop_rel_t
            g.loop_yaw[index] = kf.loop_rel_yaw
            self._opt_pending = True
            # immediate drift update (:901-922): the keyframe where the edge
            # places it relative to the old keyframe's graph pose; the next
            # 4-DoF solve refines the whole graph
            old = self.keyframes[kf.loop_index]
            w_P_cur = old.p + nplie.q2R(old.q) @ kf.loop_rel_t
            yaw_cur = _ypr(old.q)[0] + kf.loop_rel_yaw
            shift_r = _yawR(yaw_cur - _ypr(kf.q_vio)[0])
            self._drift = (shift_r, w_P_cur - shift_r @ kf.p_vio)
            return True

    def correct_pose(self, p_vio, q_vio, sequence=1):
        """Live output correction (vio_callback, pose_graph_node.cpp:201-279):
        the sequence shift, then the loop drift."""
        Rs, ts = self.seq_shift.get(sequence, (np.eye(3), np.zeros(3)))
        r_drift, t_drift = self._drift
        p = Rs @ np.asarray(p_vio, float) + ts
        q = nplie.qmul(nplie.R2q(Rs), np.asarray(q_vio, float))
        return r_drift @ p + t_drift, nplie.qmul(nplie.R2q(r_drift), q)

    # ------------------------------------------------------------- save/load

    def save(self, path: str):
        """Map persistence (savePoseGraph, pose_graph.cpp:697-788), in the
        JAX package's npz layout."""
        with self._lock:
            ks = self.keyframes

            def stack(field, empty):
                return np.stack([getattr(k, field) for k in ks]) if ks else empty

            def device_stack(field, dtype):
                if not ks:
                    return 0
                return torch.stack([getattr(k, field) for k in ks]).to(dtype).cpu().numpy()

            np.savez_compressed(
                path,
                stamp=np.array([k.stamp for k in ks]),
                sequence=np.array([k.sequence for k in ks]),
                p_vio=stack("p_vio", np.zeros((0, 3))),
                q_vio=stack("q_vio", np.zeros((0, 4))),
                p=stack("p", np.zeros((0, 3))),
                q=stack("q", np.zeros((0, 4))),
                loop_index=np.array([k.loop_index for k in ks]),
                loop_rel_t=stack("loop_rel_t", np.zeros((0, 3))),
                loop_rel_yaw=np.array([k.loop_rel_yaw for k in ks]),
                fast_pts=device_stack("fast_pts", torch.float32),
                fast_desc=device_stack("fast_desc", torch.int8),
                fast_valid=device_stack("fast_valid", torch.bool),
            )

    def load(self, path: str):
        """Load a map as the fixed base sequence 0 (loadPoseGraph,
        pose_graph.cpp:791-870): its stored optimized poses are
        authoritative, its loop edges are re-registered (earliest loop
        index included, :825-827), and its keyframes are pinned in every
        later solve."""
        with self._lock:
            if self.keyframes:
                raise RuntimeError("load() requires an empty pose graph")
            with np.load(path) as f:
                d = {k: f[k] for k in f.files}
            n = len(d["stamp"])
            fast_pts = torch.from_numpy(d["fast_pts"]).to(self.device)
            fast_desc = torch.from_numpy(d["fast_desc"]).to(self.device).to(torch.float32)
            fast_valid = torch.from_numpy(d["fast_valid"]).to(self.device)
            no_desc = torch.zeros((0, 256), dtype=torch.float32, device=self.device)
            no_valid = torch.zeros((0,), dtype=torch.bool, device=self.device)
            g = self.graph
            for i in range(n):
                kf = KeyFrame(
                    index=i, stamp=float(d["stamp"][i]), p_vio=d["p_vio"][i],
                    q_vio=d["q_vio"][i], points_3d=np.zeros((0, 3)),
                    points_2d_norm=np.zeros((0, 2)), window_desc=no_desc, window_valid=no_valid,
                    fast_pts_norm=fast_pts[i], fast_desc=fast_desc[i], fast_valid=fast_valid[i],
                    sequence=0)
                self._add_keyframe_locked(kf, detect_loop=False)
                # the stored poses override the VIO-derived fill
                kf.p = d["p"][i]
                kf.q = d["q"][i]
                g.t[kf.index] = kf.p
                g.yaw[kf.index] = _ypr(kf.q)[0]
                li = int(d["loop_index"][i])
                if li >= 0:
                    kf.loop_index = li
                    kf.loop_rel_t = d["loop_rel_t"][i].copy()
                    kf.loop_rel_yaw = float(d["loop_rel_yaw"][i])
                    g.loop_to[kf.index] = li
                    g.loop_t[kf.index] = kf.loop_rel_t
                    g.loop_yaw[kf.index] = kf.loop_rel_yaw
                    if self.earliest_loop_index < 0 or li < self.earliest_loop_index:
                        self.earliest_loop_index = li


def capacity_round(n: int) -> int:
    k = 1
    while k < n:
        k *= 2
    return k
