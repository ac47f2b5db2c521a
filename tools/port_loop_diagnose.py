"""Diagnostics of the port's looped pipeline on the 30 s loop proxy of
`chip_smoke.py` phase 8 (the JAX proxy's room, 10 Hz, 752×480).

    python tools/port_loop_diagnose.py edges   [--device cuda]
        the fast-relocalization run: each loop edge that
        `update_keyframe_loop` replaces, verified (PnP) and relocalized,
        against the true relative pose of the two keyframes
    python tools/port_loop_diagnose.py tracks  [--device cuda]
        loop closure off: per published frame of both laps' stretch past the
        wall seen at a grazing angle (t 8.5-10.5 s and 24.5-26 s), the LK
        tracks, the essential RANSAC's inliers, and how many of each pass
        the true epipolar geometry (Sampson < 1 px)
    python tools/port_loop_diagnose.py seeds   [--device cuda]
        the main path over the 30 s proxy (loop closure off) and over phase
        8c's replayed tree, with the tracker's RANSAC generator seeded 42
        (the default), 1, 2 and 3: reboots, initialization, ATE
    python tools/port_loop_diagnose.py lk-parity
        (CPU, imports JAX) the port's tracker over the proxy to t = 25.8 s;
        at frames of both stretches, `vins_tpu.frontend.klt.lk_pyramidal`
        on the port's own inputs beside the port's LK: the same tracks?

Each mode prints its lines and a JSON summary last.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def inputs(device, seconds=30.0):
    from vins_tpu_torch.sim import proxy

    return proxy.proxy_inputs(duration=seconds, device=device, room=proxy.jax_proxy_room(device))


def geometry(inp):
    """A `proxy.Sequence` of the inputs' true camera poses (no frames)."""
    from vins_tpu_torch.core import nplie
    from vins_tpu_torch.sim import proxy

    R_b = nplie.q2R(inp.q_gt)
    return proxy.Sequence(inp.t, [], R_b @ np.asarray(proxy.R_IC_FORWARD),
                          inp.p_gt + R_b @ np.asarray(proxy.TIC))


def feed(pipe, inp, each=None):
    for fi, t in enumerate(inp.t):
        if fi > 0:
            for ti, a, w in zip(inp.imu_t[fi - 1], inp.acc[fi - 1], inp.gyr[fi - 1]):
                pipe.process_imu(float(ti), a, w)
        ev = pipe.process_image(inp.frames[fi], float(t))
        if each is not None:
            each(fi, float(t), ev)
    pipe.pg_join()


def edges(device) -> dict:
    from vins_tpu_torch.core import nplie
    from vins_tpu_torch.sim import proxy

    inp = inputs(device)
    pipe = proxy.make_pipeline(device=device, fast_relocalization=True)
    pg = pipe.pose_graph
    update, rows = pg.update_keyframe_loop, []

    def truth(stamp):
        k = int(np.argmin(np.abs(inp.t - stamp)))
        return inp.p_gt[k], nplie.q2R(inp.q_gt[k])

    def recorded(index, rel_t, rel_q, rel_yaw):
        kf = pg.keyframes[index]
        (pc, Rc), (po, Ro) = truth(kf.stamp), truth(pg.keyframes[kf.loop_index].stamp)
        t_true = Ro.T @ (pc - po)
        yaw_true = nplie.normalize_angle(nplie.R2ypr(Rc)[0] - nplie.R2ypr(Ro)[0])
        rows.append(dict(index=index, old=kf.loop_index,
                         pnp_m=float(np.linalg.norm(kf.loop_rel_t - t_true)),
                         relo_m=float(np.linalg.norm(np.asarray(rel_t) - t_true)),
                         pnp_deg=float(abs(kf.loop_rel_yaw - yaw_true)),
                         relo_deg=float(abs(rel_yaw - yaw_true))))
        print(json.dumps(rows[-1]), flush=True)
        return update(index, rel_t, rel_q, rel_yaw)

    pg.update_keyframe_loop = recorded
    feed(pipe, inp)
    med = {k: float(np.median([r[k] for r in rows])) for k in ("pnp_m", "relo_m", "pnp_deg",
                                                               "relo_deg")}
    return dict(edges=len(rows), median=med,
                max={k: float(np.max([r[k] for r in rows])) for k in med})


def tracks(device) -> dict:
    from vins_tpu_torch.frontend import fused
    from vins_tpu_torch.sim import proxy

    inp = inputs(device, 26.0)
    seq = geometry(inp)
    cur, rows = {}, []
    solve = fused.solve_relative_pose

    def recorded(a, b, m, gumbel, **kw):
        rel = solve(a, b, m, gumbel, **kw)
        fi = cur["fi"]
        t = float(inp.t[fi])
        if 8.5 <= t <= 10.5 or 24.5 <= t <= 26.0:
            mm = m.cpu().numpy()
            inl = rel.inliers.cpu().numpy() & mm
            a_, b_ = a.double().cpu().numpy(), b.double().cpu().numpy()
            good = proxy.epipolar_errors_px(seq, fi - 1, fi, a_[mm], b_[mm]) < 1.0
            good_in = proxy.epipolar_errors_px(seq, fi - 1, fi, a_[inl], b_[inl]) < 1.0
            rows.append(dict(t=round(t, 2), tracks=int(mm.sum()), tracks_true=int(good.sum()),
                             inliers=int(inl.sum()), inliers_true=int(good_in.sum())))
            print(json.dumps(rows[-1]), flush=True)
        return rel

    fused.solve_relative_pose = recorded
    try:
        pipe = proxy.make_pipeline(device=device, loop_closure=False)
        kinds = []

        def each(fi, t, ev):
            cur["fi"] = fi + 1
            if ev.get("kind") == "reboot":
                kinds.append(t)

        cur["fi"] = 0
        feed(pipe, inp, each)
    finally:
        fused.solve_relative_pose = solve

    def share(lo, hi):
        return float(np.mean([r["tracks_true"] / max(r["tracks"], 1) for r in rows
                              if lo <= r["t"] < hi]))

    return dict(reboots_s=kinds, true_share={"8.5-8.9 s": share(8.5, 8.95),
                                             "9.0-10.0 s": share(9.0, 10.05),
                                             "24.5-24.8 s": share(24.5, 24.85),
                                             "25.0-26.0 s": share(25.0, 26.05)})


def seeds(device) -> dict:
    from vins_tpu_torch.io.euroc import load_groundtruth
    from vins_tpu_torch.pipeline import Pipeline
    from vins_tpu_torch.run_euroc import replay
    from vins_tpu_torch.sim import proxy
    from vins_tpu_torch.sim.euroc_writer import write_euroc_dataset

    out = {"proxy": {}, "replay": {}}
    inp = inputs(device)
    for seed in (42, 1, 2, 3):
        pipe = proxy.make_pipeline(device=device, loop_closure=False)
        pipe.tracker._gen.manual_seed(seed)
        run = proxy.run_proxy(pipe=pipe, inputs=inp, device=device)
        kinds = [e.get("kind") for e in run.events]
        out["proxy"][seed] = dict(
            reboots_s=[float(run.t[i]) for i, k in enumerate(kinds) if k == "reboot"],
            init_published_index=kinds.index("initialized") if "initialized" in kinds else None,
            ate_m=proxy.ate_rmse_tum(pipe.trajectory, inp.t, inp.p_gt))
        print("proxy seed", seed, json.dumps(out["proxy"][seed]), flush=True)
    del inp
    with tempfile.TemporaryDirectory() as root:
        write_euroc_dataset(root, duration=16.0, period=10.0, seed=0, frame_hz=20.0,
                            device=device)
        gt = load_groundtruth(root)
        for seed in (42, 1, 2, 3):
            cfg = proxy.make_config(loop_closure=False, overlap=True, pg_skip_first_cnt=5,
                                    min_loop_num=20)
            pipe = Pipeline(cfg, proxy.euroc_camera(device=device), loop_closure=False,
                            device=device)
            pipe.tracker._gen.manual_seed(seed)
            replay(root, cfg, None, pipe=pipe, progress_every=0, device=device)
            out["replay"][seed] = dict(poses=len(pipe.trajectory),
                                       failures=pipe.estimator.failures,
                                       ate_m=proxy.ate_rmse_tum(pipe.trajectory, gt.t, gt.p))
            print("replay seed", seed, json.dumps(out["replay"][seed]), flush=True)
    return out


def lk_parity() -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from vins_tpu.frontend.klt import lk_pyramidal as jlk
    from vins_tpu_torch.frontend import fused
    from vins_tpu_torch.frontend.tracker import FeatureTracker
    from vins_tpu_torch.sim import proxy

    torch.set_num_threads(8)
    inp = inputs("cpu", 25.85)
    seq, cam = geometry(inp), proxy.euroc_camera(device="cpu")
    frames = (70, 80, 85, 90, 95, 230, 235, 240, 245, 248)
    cur, rows = {}, []
    lk = fused.lk_pyramidal

    def lift(p):
        r = cam.lift(torch.as_tensor(np.asarray(p), dtype=torch.float32))
        return (r[:, :2] / r[:, 2:3]).double().numpy()

    def recorded(prev, im, pts, valid, **kw):
        p, st = lk(prev, im, pts, valid, **kw)
        fi = cur["fi"]
        if fi in frames:
            m = (valid & st).numpy()
            jp, jst = jlk(*[jnp.asarray(x.numpy()) for x in (prev, im, pts, valid)])
            jp, jm = np.asarray(jp), np.asarray(jst) & valid.numpy()
            x0 = lift(pts.numpy())
            rows.append(dict(
                t=round(float(inp.t[fi]), 2), port_ok=int(m.sum()), jax_ok=int(jm.sum()),
                port_true=int((proxy.epipolar_errors_px(seq, fi - 1, fi, x0[m],
                                                        lift(p.numpy())[m]) < 1).sum()),
                jax_true=int((proxy.epipolar_errors_px(seq, fi - 1, fi, x0[jm],
                                                       lift(jp)[jm]) < 1).sum()),
                max_dp_px=float(np.abs(jp - p.numpy())[m & jm].max())))
            print(json.dumps(rows[-1]), flush=True)
        return p, st

    fused.lk_pyramidal = recorded
    try:
        tracker = FeatureTracker(cam, max_cnt=150, min_dist=30, device="cpu")
        for fi, t in enumerate(inp.t):
            cur["fi"] = fi
            tracker.read_image(inp.frames[fi], float(t), publish=True)
    finally:
        fused.lk_pyramidal = lk
    return dict(frames=len(rows), same_ok=all(r["port_ok"] == r["jax_ok"] for r in rows),
                same_true=all(r["port_true"] == r["jax_true"] for r in rows),
                max_dp_px=max(r["max_dp_px"] for r in rows))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("edges", "tracks", "seeds", "lk-parity"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.mode == "lk-parity":
        out = lk_parity()
    else:
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out = {"edges": edges, "tracks": tracks, "seeds": seeds}[args.mode](args.device)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
