"""Port parity: loop closure inside `Pipeline` (vins_tpu_torch.pipeline)
against `vins_tpu.pipeline.Pipeline(loop_closure=True)` on the CPU, piece by
piece.

One SyntheticDriver run (tests/test_reloc.py:73's scene: 25 frames at 10 Hz,
IMU at 200 Hz) drives the JAX pipeline's estimator.  After every frame that
marginalizes a keyframe, the JAX estimator's whole state is copied into the
port pipeline's estimator (`convert.estimator_state`), both pipelines share
one image ring, and both build the keyframe payload: the same gates fire
(first-count, count and distance skips, a missing image) and the payloads
are equal (stamps and poses to 1e-12, world points to 1e-9 m, the rest
exactly).  Two payloads, with poses and 752×480 frames of the JAX proxy's
room put in, go through both `_pg_process`: the FAST corners, their flags and
the add_keyframe results are equal, the BRIEF bits ≥ 99.9 % equal (as
tests/test_torch_loop.py holds them), the two-view corner depth of the
second keyframe, chained through `_prev_kf_fast`, within 1e-3 of each
point's distance (median 1e-4; float32 triangulation on both sides from
corners an ulp apart).  Then the relocalization round trip of
tests/test_reloc.py:73-138 through both: the same match armed by
`_apply_relo`, the next window solve's `relo` event (rel_t to 1e-9 m,
rel_q to 1e-9, rel_yaw to 1e-7°), the match consumed, and
`_maybe_relo_feedback` → `PoseGraph.update_keyframe_loop` leaving the same
loop edge, graph arrays and drift (1e-9).  The worker's queue semantics run
with `_pg_process` stubbed (no JAX).

`vins_tpu.loop.brief.fast_detect` fails on its second trace in a process
(ROADMAP Queue 3, "Not a port item"); while the JAX keyframe program traces,
the module attribute is the same function jitted with the threshold static,
so this file never fills the original's cache."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vins_tpu.config import VinsConfig as JConfig
from vins_tpu.loop import brief as jb
from vins_tpu.pipeline import Pipeline as JPipeline
from vins_tpu.sim import proxy as jproxy
from vins_tpu.sim.driver import SyntheticDriver
from vins_tpu.sim.window import R_IC_FORWARD
from vins_tpu_torch import convert
from vins_tpu_torch.core import nplie
from vins_tpu_torch.estimator.estimator import NON_LINEAR
from vins_tpu_torch.pipeline import Pipeline as TPipeline
from vins_tpu_torch.sim import proxy as tproxy
from vins_tpu_torch.sim.render import RoomRenderer

torch.set_num_threads(4)
N_FRAMES = 35
MISSING = 1.0 + 17 / 10.0  # the stamp whose image the ring lacks
POSES = [(np.array([4.0, 0.0, 1.0]), nplie.R2q(nplie.ypr2R(np.array([90.0, 0.0, 0.0])))),
         (np.array([3.65, 0.05, 1.0]), nplie.R2q(nplie.ypr2R(np.array([93.0, 1.0, 0.0]))))]
jfast_detect = jax.jit(jb.fast_detect.__wrapped__,
                       static_argnames=("max_pts", "cell", "threshold", "border"))


def make_cfg(**kw):
    """tests/test_reloc.py:76's estimator config with loop closure on and
    every ingestion gate in play."""
    return JConfig(estimate_extrinsic=0, extrinsic_R=tuple(map(tuple, np.asarray(R_IC_FORWARD))),
                   extrinsic_t=(0.06, -0.01, 0.02), g_norm=9.81, acc_n=0.01, gyr_n=0.001,
                   acc_w=1e-5, gyr_w=1e-6, loop_closure=True, fast_relocalization=True,
                   pg_skip_first_cnt=2, pg_skip_cnt=1, pg_skip_dis=0.4, **kw)


def jax_gumbel():
    """The JAX PoseGraph's draws (PRNGKey(11), split per verification)."""
    state = {"key": jax.random.PRNGKey(11)}

    def draw(shape):
        state["key"], sub = jax.random.split(state["key"])
        return np.asarray(jax.random.gumbel(sub, shape, jnp.float32))

    return draw


def render(p_b, q_b, seed):
    cam = tproxy.euroc_camera(device="cpu")
    ren = RoomRenderer(cam, tproxy.EUROC_H, tproxy.EUROC_W, room=tproxy.jax_proxy_room("cpu"),
                       tic=tproxy.TIC, Ric=np.asarray(tproxy.R_IC_FORWARD))
    img = ren.render_body(p_b, q_b)
    noise = np.random.default_rng(seed).normal(0.0, tproxy.PIX_NOISE, img.shape)
    return np.clip(img + noise, 0.0, 255.0).astype(np.float32)


def relo_match(est):
    """tests/test_reloc.py:100-125: an old keyframe fabricated from window
    frame W-3's camera, shifted, and this window's landmarks projected into
    it (ids, normalized points)."""
    col = est.W - 3
    Rb = nplie.q2R(est.q[col])
    p_old_cam = est.p[col] + Rb @ est.tic + np.array([0.15, -0.1, 0.05])
    q_old_cam = nplie.qmul(est.q[col], est.qic)
    R_old = nplie.q2R(q_old_cam)
    db, Ric = est.db, nplie.q2R(est.qic)
    ids, pts_old = [], []
    for k in np.nonzero(db.used & (db.inv_depth > 0))[0]:
        a = int(db.anchor[k])
        ray = np.append(db.pt[k, a], 1.0) / db.inv_depth[k]
        Xw = nplie.q2R(est.q[a]) @ (Ric @ ray + est.tic) + est.p[a]
        Pc = R_old.T @ (Xw - p_old_cam)
        if Pc[2] < 0.2:
            continue
        ids.append(int(db.ids[k]))
        pts_old.append(Pc[:2] / Pc[2])
        if len(ids) >= 60:
            break
    return dict(kf_index=1, stamp=float(est.timestamps[col]), old_index=0,
                ids=np.asarray(ids), pts_old=np.asarray(pts_old))


@pytest.fixture(scope="module")
def runs():
    jcfg = make_cfg()
    jpipe = JPipeline(jcfg, jproxy.euroc_camera(), imu_buf_len=64)
    tpipe = TPipeline(convert.vins_config(jcfg), tproxy.euroc_camera(device="cpu"),
                      imu_buf_len=64, device="cpu", gumbel=jax_gumbel())
    jest, test = jpipe.estimator, tpipe.estimator
    ring = []
    jpipe._img_ring = tpipe._img_ring = ring
    state = {"payloads": True, "calls": []}
    payloads = []
    imu, image = jest.process_imu, jest.process_image

    def rec_imu(dt, acc, gyr):
        state["calls"].append(("imu", (dt, np.array(acc), np.array(gyr))))
        return imu(dt, acc, gyr)

    def rec_image(ids, pts, vels, uvs, t, toffs=0.0):
        state["calls"].append(("img", (np.array(ids), np.array(pts), np.array(vels),
                                       np.array(uvs), t)))
        ev = image(ids, pts, vels, uvs, t, toffs)
        if state["payloads"]:
            if abs(t - MISSING) > 1e-9:
                ring.append((t, np.full((2, 2), t, np.float32)))
                del ring[:-8]
            if ev.get("marg_old") and jest.solver_flag == NON_LINEAR:
                convert.estimator_state(jest, test)
                payloads.append((t, jpipe._build_keyframe_payload(),
                                 tpipe._build_keyframe_payload()))
        return ev

    jest.process_imu, jest.process_image = rec_imu, rec_image
    driver = SyntheticDriver(imu_hz=200.0, frame_hz=10.0, g_norm=9.81)
    driver.run(jest, n_frames=N_FRAMES)
    assert jest.solver_flag == NON_LINEAR
    state["payloads"] = False

    # two payloads through both keyframe stages, at poses and frames of the
    # JAX proxy's room
    pairs = [(jp, tp) for _, jp, tp in payloads if jp is not None][:2]
    kfs = {"jax": [], "port": []}
    patched, jb.fast_detect = jb.fast_detect, jfast_detect
    try:
        for k, ((jp, tp), (p_b, q_b)) in enumerate(zip(pairs, POSES)):
            img = render(p_b, q_b, seed=k)
            for name, pipe, pay in (("jax", jpipe, jp), ("port", tpipe, tp)):
                pay = dict(pay, p_b=p_b.copy(), q_b=q_b.copy(), img=img)
                res = pipe._pg_process(pay)
                kfs[name].append((res, pipe.pose_graph.keyframes[-1]))
    finally:
        jb.fast_detect = patched

    # the relocalization round trip: the same match through both pipelines,
    # then one more frame through both estimators
    convert.estimator_state(jest, test)
    landmarks = (jpipe.landmarks_world(), tpipe.landmarks_world())
    for pipe in (jpipe, tpipe):
        pipe.pose_graph.keyframes[1].loop_index = 0  # the loop edge the relo refines
    match = relo_match(jest)
    jpipe._apply_relo(match)
    tpipe._apply_relo(match)
    armed = (dict(jest._relo), dict(test._relo), jpipe._relo_kf_index, tpipe._relo_kf_index)
    state["calls"] = []
    jev = driver.run(jest, n_frames=1, t0=1.0 + N_FRAMES / 10.0).events[-1]
    for kind, args in state["calls"]:
        tev = test.process_imu(*args) if kind == "imu" else test.process_image(*args)
    jpipe._maybe_relo_feedback(jev)
    tpipe._maybe_relo_feedback(tev)
    return dict(jpipe=jpipe, tpipe=tpipe, payloads=payloads, kfs=kfs, match=match,
                armed=armed, jev=jev, tev=tev, landmarks=landmarks)


def test_payload_gates_match_jax(runs):
    """The same keyframes pass the gates in both pipelines: the first two
    (SKIP_FIRST_CNT), every other one after that (SKIP_CNT), those within
    SKIP_DIS of the last one sent and the one whose image is missing are
    held back."""
    pattern = [(t, jp is None, tp is None) for t, jp, tp in runs["payloads"]]
    assert [j for _, j, _ in pattern] == [p for _, _, p in pattern], pattern
    gated = {round(t, 6): j for t, j, _ in pattern}
    assert gated[2.0] and gated[2.1]                      # the first count
    assert gated[2.2] and not gated[2.4] and gated[2.6]   # one in two
    assert gated[round(MISSING + 0.1, 6)]                 # frame F-3 has no image
    assert gated[3.6]                                     # 0.34 m from the last one sent
    assert sum(not j for j in gated.values()) >= 3


@pytest.mark.parametrize("field", ["t", "p_b", "q_b", "tic", "pts3d", "pts2d", "uv", "fids",
                                   "n_landmarks", "sequence", "img"])
def test_payload_matches_jax(runs, field):
    pairs = [(jp, tp) for _, jp, tp in runs["payloads"] if jp is not None]
    assert len(pairs) >= 3
    tol = {"t": 1e-12, "p_b": 1e-12, "q_b": 1e-12, "tic": 1e-12, "pts3d": 1e-9}.get(field, 0.0)
    for jp, tp in pairs:
        a, b = np.asarray(jp[field]), np.asarray(tp[field])
        assert a.shape == b.shape and a.dtype == b.dtype, (field, a.dtype, b.dtype)
        np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=field)


def test_landmarks_world_matches_jax(runs):
    """pubPointCloud's payload from the same estimator state, by the
    payload's own world-point math."""
    jl, tl = runs["landmarks"]
    assert tl.shape == jl.shape and len(tl) >= 20
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-9)


def test_keyframe_features_match_jax(runs):
    (jres0, jk0), (jres1, jk1) = runs["kfs"]["jax"]
    (tres0, tk0), (tres1, tk1) = runs["kfs"]["port"]
    for jk, tk in ((jk0, tk0), (jk1, tk1)):
        # the same corners; their normalized coordinates come from the
        # float32 undistortion, whose op order differs by an ulp
        np.testing.assert_allclose(tk.fast_pts.numpy(), np.asarray(jk.fast_pts), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(tk.fast_valid.numpy(), np.asarray(jk.fast_valid))
        assert int(tk.fast_valid.sum()) > 100
        for f in ("fast_desc", "window_desc"):
            bits = float(np.mean(getattr(tk, f).numpy() == np.asarray(getattr(jk, f))))
            assert bits >= 0.999, (f, bits)
        np.testing.assert_array_equal(tk.window_valid.numpy(), np.asarray(jk.window_valid))
        for f in ("p_vio", "q_vio", "p", "q", "points_3d", "points_2d", "point_ids", "window_uv"):
            np.testing.assert_allclose(getattr(tk, f), np.asarray(getattr(jk, f)), rtol=0,
                                       atol=1e-9 if f == "points_3d" else 0.0, err_msg=f)
        assert tk.stamp == jk.stamp and tk.sequence == jk.sequence and tk.index == jk.index
    # the first keyframe has no predecessor: no corner depth; the second's
    # comes from the first's corners, chained through _prev_kf_fast
    assert not tk0.fast_3d_valid.any() and not np.asarray(jk0.fast_3d_valid).any()
    np.testing.assert_array_equal(tk1.fast_3d_valid, np.asarray(jk1.fast_3d_valid))
    assert tk1.fast_3d_valid.sum() >= 20
    # float32 triangulation from corners an ulp apart (each pipeline chains
    # its own): measured ≤ 2.8e-4 of the point's distance, median 1.4e-5
    m = tk1.fast_3d_valid
    rel = (np.linalg.norm(tk1.fast_3d[m] - np.asarray(jk1.fast_3d)[m], axis=1)
           / np.linalg.norm(np.asarray(jk1.fast_3d)[m], axis=1))
    assert rel.max() <= 1e-3 and np.median(rel) <= 1e-4, (rel.max(), np.median(rel))
    prev = runs["tpipe"]._prev_kf_fast
    assert prev["pts"] is tk1.fast_pts and prev["desc"] is tk1.fast_desc
    for jres, tres in ((jres0, tres0), (jres1, tres1)):
        assert tres.keys() == jres.keys()
        for k in ("index", "loop", "candidate", "stamp"):
            assert tres[k] == jres[k], k
        np.testing.assert_array_equal(np.asarray(tres["scores"]), np.asarray(jres["scores"]))


def test_relo_round_trip_matches_jax(runs):
    jrelo, trelo, jkf, tkf = runs["armed"]
    assert jkf == tkf == runs["match"]["kf_index"]
    assert trelo["n"] == jrelo["n"] >= 12
    for f in ("pt", "valid"):
        np.testing.assert_array_equal(trelo[f], jrelo[f])
    jev, tev = runs["jev"], runs["tev"]
    assert tev["kind"] == jev["kind"] == "vio"
    jr, tr = jev["relo"], tev["relo"]
    assert tr["ok"] and jr["ok"]
    np.testing.assert_allclose(tr["rel_t"], jr["rel_t"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(tr["rel_q"], jr["rel_q"], rtol=0, atol=1e-9)
    assert abs(tr["rel_yaw"] - jr["rel_yaw"]) < 1e-7
    jp, tp = runs["jpipe"], runs["tpipe"]
    assert tp.estimator._relo is None and jp.estimator._relo is None
    assert tp._relo_kf_index is None and jp._relo_kf_index is None


def test_update_keyframe_loop_matches_jax(runs):
    jg, tg = runs["jpipe"].pose_graph, runs["tpipe"].pose_graph
    jk, tk = jg.keyframes[1], tg.keyframes[1]
    assert tk.loop_index == jk.loop_index == 0
    np.testing.assert_allclose(tk.loop_rel_t, runs["tev"]["relo"]["rel_t"], rtol=0, atol=0)
    for f in ("loop_rel_t", "loop_rel_q"):
        np.testing.assert_allclose(getattr(tk, f), getattr(jk, f), rtol=0, atol=1e-9)
    assert abs(tk.loop_rel_yaw - jk.loop_rel_yaw) < 1e-7
    for f in ("loop_to", "loop_t", "loop_yaw", "t", "yaw"):
        np.testing.assert_allclose(getattr(tg.graph, f)[:2], getattr(jg.graph, f)[:2], rtol=0,
                                   atol=1e-7 if f.endswith("yaw") else 1e-9, err_msg=f)
    np.testing.assert_allclose(tg.r_drift, jg.r_drift, rtol=0, atol=1e-9)
    np.testing.assert_allclose(tg.t_drift, jg.t_drift, rtol=0, atol=1e-9)
    assert tg._opt_pending and jg._opt_pending


# ----------------------------------------------------- without JAX programs


def port_pipeline(**kw):
    cfg = convert.vins_config(make_cfg(**kw))
    return TPipeline(cfg, tproxy.euroc_camera(device="cpu"), imu_buf_len=64, device="cpu")


def test_worker_queue_semantics():
    """FIFO, drops counted at maxsize 4, an exception becomes an "error"
    event and the worker lives on, pg_join drains (the relocalization
    queue too), shutdown joins the thread."""
    pipe = port_pipeline(pg_async=True)
    assert pipe.pg_async and pipe._pg_thread.is_alive() and pipe._pg_queue.maxsize == 4
    assert pipe.pg_tracer is not pipe.tracer and pipe.pg_tracer.sync is None
    pipe.estimator.solver_flag = NON_LINEAR
    started, gate, applied = threading.Event(), threading.Event(), []
    stamps = iter(range(100))
    pipe._build_keyframe_payload = lambda: {"t": next(stamps)}
    pipe._apply_relo = applied.append

    def process(payload):
        t = payload["t"]
        if t == 0:
            started.set()
            gate.wait(timeout=30)
        if t == 3:
            raise ValueError("boom")
        if t == 4:
            pipe._relo_queue.append({"kf_index": t})
        return {"stamp": t}

    pipe._pg_process = process
    pipe._downstream({"marg_old": True}, 0.0)
    assert started.wait(timeout=30)
    for k in range(1, 10):
        pipe._downstream({"marg_old": True}, 0.1 * k)
    assert pipe.pg_dropped == 5 and pipe._pg_queue.qsize() == 4
    gate.set()
    pipe.pg_join()
    assert pipe._pg_queue.unfinished_tasks == 0
    assert pipe.pg_events[:3] == [{"stamp": 0}, {"stamp": 1}, {"stamp": 2}]
    assert pipe.pg_events[3] == {"error": "ValueError('boom')"}
    assert pipe.pg_events[4:] == [{"stamp": 4}]
    assert applied == [{"kf_index": 4}] and pipe._relo_queue == []
    assert pipe._pg_thread.is_alive()  # the error did not end the worker
    pipe.shutdown()
    assert not pipe._pg_thread.is_alive() and not pipe.pg_async


def test_construct_and_write_trajectories(tmp_path):
    """Pipeline(loop_closure=True) constructs, serial and overlapped, and
    with the loop-match debug image; both TUM files are written as the JAX
    pipeline writes them."""
    for overlap in (False, True):
        pipe = port_pipeline()
        pipe2 = TPipeline(pipe.cfg, pipe.camera, device="cpu", overlap=overlap)
        assert pipe2.pose_graph is not None and pipe2.overlap == overlap
        assert not pipe2.pg_async and pipe2.pg_tracer is pipe2.tracer
    debug = port_pipeline(debug_image=True)
    assert debug.cfg.debug_image and debug.pose_graph is not None
    assert debug.last_loop_image is None
    off = TPipeline(dataclasses.replace(pipe.cfg, loop_closure=False), pipe.camera,
                    device="cpu", loop_closure=False)
    assert off.pose_graph is None

    rng = np.random.default_rng(0)
    traj = [(1.0 + 0.1 * k, rng.normal(size=3), nplie.qnormalize(rng.normal(size=4)))
            for k in range(5)]
    loop = [(t, p + 0.01, q) for t, p, q in traj]
    jpipe = JPipeline.__new__(JPipeline)
    for pipe_, tag in ((pipe, "port"), (jpipe, "jax")):
        pipe_.trajectory, pipe_.trajectory_loop = traj, loop
        pipe_.write_trajectories(str(tmp_path / f"{tag}_vio.tum"),
                                 str(tmp_path / f"{tag}_loop.tum"))
    for kind in ("vio", "loop"):
        port = (tmp_path / f"port_{kind}.tum").read_text()
        assert port == (tmp_path / f"jax_{kind}.tum").read_text()
        assert len(port.splitlines()) == 5

