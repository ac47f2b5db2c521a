"""The real-data proxy end to end, scored against its closed-form truth.

Counterpart of `tools/run_proxy.py`: rendered 752×480 textured-room frames
through the EuRoC-distorted camera and a noisy biased 200 Hz IMU drive the
whole pipeline (front-end → estimator → with `--loop`, the pose graph on
its worker thread) around a closed circuit; the run's VIO (and corrected)
trajectories are scored by SE(3) and 4-DoF ATE.  The estimator is float64
unless `--dtype float32`, on `--device` (each VIO step one CUDA graph
replay on the card).

    python -m vins_tpu_torch.run_proxy [--duration 20] [--period 16]
        [--frame-hz 10] [--seed 0] [--loop | --no-loop] [--no-noise]
        [--device cuda|cpu] [--dtype float64|float32] [--debug-image]
        [--out-dir DIR]

Prints the pipeline's report (`Pipeline.print_statistics`), then as the
last line of standard output one JSON object with the JAX tool's keys.
Files are written only under `--out-dir`: proxy_vio_{tag}.tum,
proxy_corrected_{tag}.tum, proxy_gt.tum, proxy_pgpath_{tag}.tum and
proxy_{tag}_seed{seed}.json (tag "loop" or "no_loop"), and with
`--debug-image` one proxy_loopmatch_{tag}_{k}.ppm per verified loop.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .io.euroc import write_tum
from .sim.proxy import ProxyRun, ate_rmse_tum, make_pipeline, run_proxy
from .utils.viz import save_ppm

DTYPES = {"float64": torch.float64, "float32": torch.float32}


def stage_ms(pipe) -> dict:
    """The tracer's per-stage statistics, the pose-graph worker's included."""
    snap = pipe.tracer.stats.snapshot()
    if pipe.pg_tracer is not pipe.tracer:
        snap.update(pipe.pg_tracer.stats.snapshot())
    return snap


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--period", type=float, default=16.0)
    ap.add_argument("--frame-hz", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loop", dest="loop", action="store_true", default=True)
    ap.add_argument("--no-loop", dest="loop", action="store_false")
    ap.add_argument("--no-noise", dest="noise", action="store_false", default=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dtype", default="float64", choices=tuple(DTYPES))
    ap.add_argument("--debug-image", action="store_true",
                    help="keep keyframe images and save every loop-match image")
    ap.add_argument("--out-dir", default=None, help="where files go (none without it)")
    args = ap.parse_args(argv)
    if args.debug_image and not (args.loop and args.out_dir):
        ap.error("--debug-image saves loop-match images: it needs --loop and --out-dir")
    return args


def main(argv=None) -> tuple[dict, ProxyRun]:
    """Run, report and score; returns the JSON's dict and the run."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_proxy: no CUDA device is visible (use --device cpu)")

    t0 = time.time()
    pipe = make_pipeline(device=args.device, loop_closure=args.loop, dtype=DTYPES[args.dtype],
                         pg_async=args.loop, debug_image=args.debug_image)
    tag = "loop" if args.loop else "no_loop"
    out = args.out_dir
    saved = []  # keyframe index of each loop-match image, saved as it is drawn
    if args.debug_image:
        os.makedirs(out, exist_ok=True)

        def save(index, img):
            save_ppm(os.path.join(out, f"proxy_loopmatch_{tag}_{len(saved):03d}.ppm"), img)
            saved.append(index)

        pipe.loop_image_sink = save
    run = run_proxy(
        duration=args.duration, pipe=pipe, device=args.device, period=args.period,
        frame_hz=args.frame_hz, seed=args.seed, imu_noise=args.noise,
        progress=lambda i, n, ev: print(
            f"frame {i}/{n} {ev.get('kind')} t={time.time() - t0:.0f}s", flush=True))
    wall = time.time() - t0

    kinds = [e.get("kind") for e in run.events]
    kf_evs = [e for e in pipe.pg_events if "candidate" in e]
    gates = {
        "keyframes_queried": len(kf_evs),
        "dropped_backpressure": pipe.pg_dropped,
        "no_candidate": sum(1 for e in kf_evs if e["candidate"] is None),
        "desc_matches": sum(1 for e in kf_evs if str(e.get("verify", "")).startswith("desc")),
        "pnp": sum(1 for e in kf_evs if str(e.get("verify", "")).startswith("pnp")),
        "relative": sum(1 for e in kf_evs if str(e.get("verify", "")).startswith("relative")),
        "ok": sum(1 for e in kf_evs if e.get("verify") == "ok"),
    }
    loops = [{"t": round(float(e["stamp"]), 2), "old": int(e["loop"])}
             for e in kf_evs if e.get("loop") is not None]
    gt_path_m = float(np.linalg.norm(np.diff(run.p_gt, axis=0), axis=1).sum())
    ate_vio = ate_rmse_tum(pipe.trajectory, run.t, run.p_gt)
    res = {
        "duration_s": args.duration,
        "period_s": args.period,
        "seed": args.seed,
        "imu_noise": args.noise,
        "min_loop_num": pipe.cfg.min_loop_num,
        "frames_published": len(run.events),
        "kinds": {k: kinds.count(k) for k in set(kinds)},
        "reboots": int(pipe.estimator.failures),
        "loops_detected": run.n_loops,
        "loops": loops[:50],
        "gates": gates,
        "gt_path_m": round(gt_path_m, 2),
        "ate_vio_m": ate_vio,
        "ate_vio_pct_path": round(100.0 * ate_vio / gt_path_m, 3),
        "ate_vio_4dof_m": ate_rmse_tum(pipe.trajectory, run.t, run.p_gt, align="yaw"),
        "wall_s": round(wall, 1),
        "stage_ms": stage_ms(pipe),
    }
    if out:
        os.makedirs(out, exist_ok=True)
        pipe.write_trajectories(os.path.join(out, f"proxy_vio_{tag}.tum"),
                                os.path.join(out, f"proxy_corrected_{tag}.tum"))
        write_tum(os.path.join(out, "proxy_gt.tum"), run.t, run.p_gt, run.q_gt)
    if args.loop and pipe.trajectory_loop:
        ate_c = ate_rmse_tum(pipe.trajectory_loop, run.t, run.p_gt)
        res["ate_corrected_m"] = ate_c
        res["ate_corrected_pct_path"] = round(100.0 * ate_c / gt_path_m, 3)
        res["pose_graph_keyframes"] = len(pipe.pose_graph.keyframes)
        res["pose_graph_optimizes"] = pipe.pose_graph.n_optimizes
        # the reference's vins_result_loop.csv is the optimized keyframe path
        # (pose_graph.cpp:628-644), not the live corrected stream
        kf_path = [(k.stamp, k.p, k.q) for k in pipe.pose_graph.keyframes]
        res["ate_pose_graph_path_m"] = ate_rmse_tum(kf_path, run.t, run.p_gt)
        if out and kf_path:
            write_tum(os.path.join(out, f"proxy_pgpath_{tag}.tum"),
                      np.asarray([e[0] for e in kf_path]), np.stack([e[1] for e in kf_path]),
                      np.stack([e[2] for e in kf_path]))
    if args.debug_image:
        res["loop_images"] = len(saved)
    if out:
        with open(os.path.join(out, f"proxy_{tag}_seed{args.seed}.json"), "w") as f:
            json.dump(res, f, indent=1)
    print(pipe.print_statistics(), flush=True)
    print(json.dumps(res), flush=True)
    return res, run


if __name__ == "__main__":
    main()
