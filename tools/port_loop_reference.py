"""The JAX pipeline's loop-closure numbers on the port's 30 s proxy inputs
(CPU, float64).

Renders the inputs of `chip_smoke.py` phase 8 with the port
(`vins_tpu_torch.sim.proxy.proxy_inputs` on the CPU, in the JAX proxy's room
`jax_proxy_room`: 30 s at 10 Hz along the radius-4, period-16 circuit,
752×480, pixel noise σ = 2, a 200 Hz noisy biased IMU from
`np.random.default_rng(0)`), feeds the same frames (as numpy) and IMU
samples to the JAX `Pipeline` with loop closure on (the proxy config of
`vins_tpu/sim/proxy.py:53-76`: pg_skip_first_cnt 10, min_loop_num 25,
pg_opt_interval 2 s; serial, the pose graph in line, fast relocalization
on), and prints its frame of initialization, failures, verified loops (and
how many are false: true keyframe positions more than 1.5 m or true yaws
more than 30° apart), 4-DoF solves, relocalization round trips and the
SE(3) ATE of the VIO and of the corrected trajectory.  The port's
`Pipeline` on the CPU runs the same inputs beside it, with its own draws.
The phase-8 limits in `chip_smoke.py` come from these numbers.

With `--replay`, it writes instead the EuRoC-layout tree of phase 8c with
the port's writer (`sim/euroc_writer.py` on the CPU: 16 s, circuit period
10 s, seed 0, 20 Hz frames, tests/test_euroc_replay_loop.py:24-44) and
replays it through the JAX tool (`tools/run_euroc.py::replay`, loop closure
on, that test's config), then through the port's `run_euroc.replay` on the
CPU, and prints each one's failures, poses, loops, 4-DoF solves and ATE.

    python tools/port_loop_reference.py [--seconds 30] [--skip-port]
        [--no-fast-relocalization]
    python tools/port_loop_reference.py --replay [--skip-port]

Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FALSE_LOOP_M, FALSE_LOOP_DEG = 1.5, 30.0


def false_loops(pipe, inp) -> list:
    """(i, j, Δp m, Δyaw °) of each verified loop whose keyframes' true poses
    are more than FALSE_LOOP_M or FALSE_LOOP_DEG apart."""
    from vins_tpu_torch.core import nplie

    def truth(stamp):
        k = int(np.argmin(np.abs(inp.t - stamp)))
        return inp.p_gt[k], nplie.R2ypr(nplie.q2R(inp.q_gt[k]))[0]

    out = []
    kfs = pipe.pose_graph.keyframes
    for e in pipe.pg_events:
        if e.get("loop") is None:
            continue
        (pi, yi), (pj, yj) = truth(kfs[e["index"]].stamp), truth(kfs[e["loop"]].stamp)
        dp = float(np.linalg.norm(pi - pj))
        dyaw = abs((yi - yj + 180.0) % 360.0 - 180.0)
        if dp > FALSE_LOOP_M or dyaw > FALSE_LOOP_DEG:
            out.append((e["index"], e["loop"], round(dp, 3), round(float(dyaw), 2)))
    return out


def replay_reference(skip_port: bool) -> dict:
    """Phase 8c's tree through the JAX replay and the port's (CPU)."""
    import tempfile

    from vins_tpu.config import VinsConfig as JConfig
    from vins_tpu.sim import proxy as jproxy
    from vins_tpu_torch.io.euroc import load_groundtruth
    from vins_tpu_torch.run_euroc import replay as treplay
    from vins_tpu_torch.sim import proxy as tproxy
    from vins_tpu_torch.sim.euroc_writer import write_euroc_dataset

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from run_euroc import replay as jreplay

    out = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        info = write_euroc_dataset(root, duration=16.0, period=10.0, seed=0, frame_hz=20.0,
                                   device="cpu")
        out.update(frames=info["n_frames"], write_s=time.perf_counter() - t0)
        gt = load_groundtruth(root)
        kw = dict(pg_skip_first_cnt=5, min_loop_num=20)
        for name in ("jax",) + (() if skip_port else ("port_cpu",)):
            t0 = time.perf_counter()
            if name == "jax":
                cfg = JConfig(image_width=752, image_height=480, focal=460.0, max_cnt=150,
                              min_dist=30, freq=10, max_landmarks=256, g_norm=9.81,
                              extrinsic_R=tproxy.R_IC_FORWARD, extrinsic_t=tuple(tproxy.TIC),
                              acc_n=0.08, gyr_n=0.004, loop_closure=True, **kw)
                pipe = jreplay(root, cfg, jproxy.euroc_camera(), loop=True, progress_every=0)
            else:
                cfg = tproxy.make_config(overlap=True, **kw)
                pipe = treplay(root, cfg, tproxy.euroc_camera(device="cpu"), loop=True,
                               progress_every=0, device="cpu")
            s = dict(failures=int(pipe.estimator.failures), poses=len(pipe.trajectory),
                     loops=sum(e.get("loop") is not None for e in pipe.pg_events),
                     n_optimizes=int(pipe.pose_graph.n_optimizes),
                     ate_vio_m=tproxy.ate_rmse_tum(pipe.trajectory, gt.t, gt.p),
                     ate_loop_m=tproxy.ate_rmse_tum(pipe.trajectory_loop, gt.t, gt.p),
                     run_s=time.perf_counter() - t0)
            out[name] = s
            print(f"{name}: " + json.dumps(s), file=sys.stderr, flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--skip-port", action="store_true", help="run the JAX pipeline only")
    ap.add_argument("--no-fast-relocalization", action="store_true",
                    help="fast relocalization off (the config's default)")
    ap.add_argument("--replay", action="store_true", help="phase 8c's replayed tree instead")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from vins_tpu.sim import proxy as jproxy
    from vins_tpu_torch.sim import proxy as tproxy

    torch.set_num_threads(8)
    if args.replay:
        print(json.dumps(replay_reference(args.skip_port)))
        return 0
    t0 = time.perf_counter()
    inp = tproxy.proxy_inputs(duration=args.seconds, device="cpu",
                              room=tproxy.jax_proxy_room("cpu"))
    frames = [f.numpy() for f in inp.frames]
    out = {"seconds": args.seconds, "frames": len(frames), "render_s": time.perf_counter() - t0}

    relo = not args.no_fast_relocalization
    out["fast_relocalization"] = relo
    for name in ("jax",) + (() if args.skip_port else ("port_cpu",)):
        t0 = time.perf_counter()
        if name == "jax":
            pipe = jproxy.make_pipeline(loop_closure=True, dtype=jnp.float64,
                                        fast_relocalization=relo)
        else:
            pipe = tproxy.make_pipeline(device="cpu", fast_relocalization=relo)
        updates = []
        update = pipe.pose_graph.update_keyframe_loop

        def recorded(*a, update=update, updates=updates):
            ok = update(*a)
            updates.append(bool(ok))
            return ok

        pipe.pose_graph.update_keyframe_loop = recorded
        kinds, relos = [], 0
        for fi, t in enumerate(inp.t):
            if fi > 0:
                for ti, a, w in zip(inp.imu_t[fi - 1], inp.acc[fi - 1], inp.gyr[fi - 1]):
                    pipe.process_imu(float(ti), a, w)
            img = frames[fi] if name == "jax" else torch.from_numpy(frames[fi])
            ev = pipe.process_image(img, float(t))
            if ev.get("published"):
                kinds.append(ev.get("kind"))
                relos += "relo" in ev and bool(ev["relo"].get("ok"))
        pipe.pg_join()
        pipe.shutdown()
        i0 = kinds.index("initialized") if "initialized" in kinds else None
        loops = [(e["index"], e["loop"]) for e in pipe.pg_events if e.get("loop") is not None]
        s = dict(
            init_published_index=i0, n_published=len(kinds),
            kinds_after_init=sorted(set(kinds[i0 + 1:])) if i0 is not None else [],
            failures=int(pipe.estimator.failures), keyframes=len(pipe.pose_graph.keyframes),
            loops=loops, false_loops=false_loops(pipe, inp),
            n_optimizes=int(pipe.pose_graph.n_optimizes), relo_events_ok=int(relos),
            update_keyframe_loop=updates,
            ate_vio_m=tproxy.ate_rmse_tum(pipe.trajectory, inp.t, inp.p_gt),
            ate_loop_m=tproxy.ate_rmse_tum(pipe.trajectory_loop, inp.t, inp.p_gt),
            run_s=time.perf_counter() - t0)
        out[name] = s
        print(f"{name}: " + json.dumps(s), file=sys.stderr, flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
