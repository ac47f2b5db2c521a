"""The long multi-lap proxy run: loop closure pulling the live corrected
path back onto the truth (pose_graph.cpp:403-579).

Counterpart of `tools/run_longrun.py`: the proxy (`run_proxy`'s scene) on a
circuit of `--radius` m and `--period` s, long enough for the VIO to drift,
with loop detection throttled to sparse keyframes (pg_skip_first_cnt 10,
pg_skip_cnt 2, pg_skip_dis 0.25 m, a 4-DoF solve at most every 3 s), the
pose graph on its worker thread, the overlapped frame loop and the fast
relocalization round trip.  The estimator is float64 unless `--dtype
float32`, on `--device`.

    python -m vins_tpu_torch.run_longrun [--duration 200] [--period 25]
        [--radius 6] [--seed 0] [--device cuda|cpu] [--dtype float64|float32]
        [--out-dir DIR]

The last line of standard output is one JSON object with the JAX tool's
keys.  Files are written only under `--out-dir`: proxy_longrun.json,
longrun_vio.tum, longrun_corrected.tum and longrun_gt.tum.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .io.euroc import write_tum
from .run_proxy import DTYPES
from .sim.proxy import ProxyRun, ate_rmse_tum, make_pipeline, run_proxy


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--duration", type=float, default=200.0)
    ap.add_argument("--period", type=float, default=25.0)
    ap.add_argument("--radius", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dtype", default="float64", choices=tuple(DTYPES))
    ap.add_argument("--out-dir", default=None, help="where files go (none without it)")
    return ap.parse_args(argv)


def main(argv=None) -> tuple[dict, ProxyRun]:
    """Run and score; returns the JSON's dict and the run."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_longrun: no CUDA device is visible (use --device cpu)")

    pipe = make_pipeline(device=args.device, loop_closure=True, dtype=DTYPES[args.dtype],
                         pg_async=True, overlap=True, pg_skip_first_cnt=10, pg_skip_cnt=2,
                         pg_skip_dis=0.25, pg_opt_interval=3.0, fast_relocalization=True)
    run = run_proxy(duration=args.duration, pipe=pipe, device=args.device, period=args.period,
                    radius=args.radius, seed=args.seed,
                    progress=lambda fi, n, ev: print(f"frame {fi}/{n} {ev.get('kind', '')}",
                                                     flush=True) if fi % 200 == 0 else None)

    gt_path_m = float(np.linalg.norm(np.diff(run.p_gt, axis=0), axis=1).sum())
    ate_vio = ate_rmse_tum(pipe.trajectory, run.t, run.p_gt)
    ate_corr = ate_rmse_tum(pipe.trajectory_loop, run.t, run.p_gt)
    kfs = pipe.pose_graph.keyframes
    ate_pg = ate_rmse_tum([(k.stamp, k.p, k.q) for k in kfs], run.t, run.p_gt)
    out = {
        "duration_s": args.duration,
        "radius_m": args.radius,
        "gt_path_m": round(gt_path_m, 2),
        "frames": len(run.t),
        "keyframes": len(kfs),
        "loops": run.n_loops,
        "relo_refined_edges": sum(1 for e in run.events if e.get("relo", {}).get("ok")),
        "pg_optimizes": pipe.pose_graph.n_optimizes,
        "pg_dropped": pipe.pg_dropped,
        "reboots": pipe.estimator.failures,
        "ate_vio_m": round(ate_vio, 4),
        "ate_vio_pct_path": round(100 * ate_vio / gt_path_m, 3),
        "ate_corrected_live_m": round(ate_corr, 4),
        "ate_corrected_pct_path": round(100 * ate_corr / gt_path_m, 3),
        "ate_pose_graph_path_m": round(ate_pg, 4),
        "improvement_live_x": round(ate_vio / max(ate_corr, 1e-9), 2),
    }
    if args.out_dir:
        d = args.out_dir
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "proxy_longrun.json"), "w") as f:
            json.dump(out, f, indent=1)
        pipe.write_trajectories(os.path.join(d, "longrun_vio.tum"),
                                os.path.join(d, "longrun_corrected.tum"))
        write_tum(os.path.join(d, "longrun_gt.tum"), run.t, run.p_gt, run.q_gt)
    print(json.dumps(out), flush=True)
    return out, run


if __name__ == "__main__":
    main()
