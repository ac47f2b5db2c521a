"""Two-session map reuse (pose_graph.cpp:697-870, savePoseGraph /
loadPoseGraph) on the proxy scene.

Counterpart of `tools/run_two_session.py`:

  session A: the looped proxy circuit (float32 estimator, the pose graph on
  its worker thread), then its pose graph saved as a map;
  session B: a NEW pipeline in the SAME room, on another circuit (radius
  3.7 m), the pose graph in line, loads the map as the pinned base sequence
  0, relocalizes against it, merges, and is scored; the base map's poses
  must be BITWISE unchanged afterwards.

    python -m vins_tpu_torch.run_two_session [--duration-a 24] [--duration-b 24]
        [--device cuda|cpu] [--out-dir DIR]

The map goes to a temporary file unless `--out-dir` is given; then
DIR/two_session_map.npz and DIR/two_session.json are written.  The last
line of standard output is the JAX tool's JSON on one line.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from .sim.proxy import ate_rmse_tum, make_pipeline, run_proxy

SESSION_A = dict(loop_closure=True, dtype=torch.float32, pg_async=True, pg_skip_first_cnt=5)
SESSION_B = dict(loop_closure=True, dtype=torch.float32, pg_async=False, pg_skip_first_cnt=5)
SCENE_A = dict(period=16.0, seed=0)
SCENE_B = dict(period=16.0, seed=0, radius=3.7)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--duration-a", type=float, default=24.0, help="session A's seconds")
    ap.add_argument("--duration-b", type=float, default=24.0, help="session B's seconds")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out-dir", default=None,
                    help="where the map and the JSON go (a temporary map without it)")
    return ap.parse_args(argv)


def sessions(args, map_path: str) -> tuple:
    """Both sessions; returns (the JSON's dict, session A's run, session B's
    run)."""
    print("session A ...", flush=True)
    pipe_a = make_pipeline(device=args.device, **SESSION_A)
    run_a = run_proxy(duration=args.duration_a, pipe=pipe_a, device=args.device, **SCENE_A)
    ate_a = ate_rmse_tum(pipe_a.trajectory, run_a.t, run_a.p_gt)
    pipe_a.pose_graph.save(map_path)
    n_base = len(pipe_a.pose_graph.keyframes)
    print(f"A: ate={ate_a:.3f} kf={n_base} loops={run_a.n_loops}", flush=True)

    # session B: the same room (the same render seed), another circuit
    print("session B ...", flush=True)
    pipe_b = make_pipeline(device=args.device, **SESSION_B)
    pipe_b.pose_graph.load(map_path)
    base_p = np.stack([k.p for k in pipe_b.pose_graph.keyframes]).copy()
    base_q = np.stack([k.q for k in pipe_b.pose_graph.keyframes]).copy()

    run_b = run_proxy(duration=args.duration_b, pipe=pipe_b, device=args.device, **SCENE_B)
    pg = pipe_b.pose_graph
    new_kfs = pg.keyframes[n_base:]
    loops_to_base = [k for k in new_kfs if 0 <= k.loop_index < n_base]
    merged = 1 in pg._merged
    base_unchanged = (
        np.array_equal(np.stack([k.p for k in pg.keyframes[:n_base]]), base_p)
        and np.array_equal(np.stack([k.q for k in pg.keyframes[:n_base]]), base_q))

    ate_b_vio = ate_rmse_tum(pipe_b.trajectory, run_b.t, run_b.p_gt)
    ate_b_corr = ate_rmse_tum(pipe_b.trajectory_loop, run_b.t, run_b.p_gt)
    out = {
        "session_a": {"ate_vio_m": round(ate_a, 4), "keyframes": n_base,
                      "loops": run_a.n_loops},
        "session_b": {
            "ate_vio_m": round(ate_b_vio, 4),
            "ate_corrected_m": round(ate_b_corr, 4),
            "keyframes_new": len(new_kfs),
            "loops_to_base_map": len(loops_to_base),
            "first_reloc_stamp": (round(loops_to_base[0].stamp, 2)
                                  if loops_to_base else None),
            "merged_onto_base": bool(merged),
            "pg_optimizes": pg.n_optimizes,
        },
        "base_map_bitwise_unchanged": bool(base_unchanged),
    }
    return out, run_a, run_b


def main(argv=None) -> tuple:
    """Run both sessions, print and (with `--out-dir`) write the JSON;
    returns (the JSON's dict, session A's run, session B's run)."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_two_session: no CUDA device is visible (use --device cpu)")
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        out, run_a, run_b = sessions(args, os.path.join(args.out_dir, "two_session_map.npz"))
        with open(os.path.join(args.out_dir, "two_session.json"), "w") as f:
            json.dump(out, f, indent=1)
    else:
        with tempfile.TemporaryDirectory() as d:
            out, run_a, run_b = sessions(args, os.path.join(d, "two_session_map.npz"))
    print(json.dumps(out), flush=True)
    return out, run_a, run_b


if __name__ == "__main__":
    main()
