"""End-to-end synthetic VIO run: the estimator alone on the closed-form
figure-8 (`sim/driver.py`), window fill → initialization → steady-state
sliding-window VIO, scored by the yaw-aligned ATE RMSE.

Counterpart of `tools/run_synthetic.py`: the same scene and config
(max_landmarks 160, g 9.81, the forward extrinsic with tic (0.06, -0.01,
0.02), 64-sample IMU intervals), a float64 estimator on `--device` (each VIO
step one CUDA graph replay on the card).

    python -m vins_tpu_torch.run_synthetic [--frames 60] [--pix-noise SIGMA]
        [--imu-hz 200] [--device cuda|cpu]

The last line of standard output is one JSON object: frames, initialized,
steady_state, ate_rmse_m, wall_s, frames_per_s.  Exits 1 unless the run
initialized with an ATE of at most 0.10 m.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .config import VinsConfig
from .estimator.estimator import NON_LINEAR, Estimator
from .sim.driver import SyntheticDriver, ate_rmse
from .sim.window import R_IC_FORWARD

ATE_MAX_M = 0.10


def make_estimator(device="cuda", imu_buf_len: int = 64, **cfg_kw) -> Estimator:
    """The run's estimator (float64, graphed on CUDA); `cfg_kw` sets any
    other `VinsConfig` field."""
    cfg = VinsConfig(max_landmarks=160, g_norm=9.81,
                     extrinsic_R=R_IC_FORWARD, extrinsic_t=(0.06, -0.01, 0.02), **cfg_kw)
    return Estimator(cfg, imu_buf_len=imu_buf_len, device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="The estimator on the synthetic figure-8.")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--pix-noise", type=float, default=0.0,
                    help="feature noise sigma on the normalized plane ×460")
    ap.add_argument("--imu-hz", type=float, default=200.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_synthetic: no CUDA device is visible (use --device cpu)")

    est = make_estimator(args.device)
    driver = SyntheticDriver(imu_hz=args.imu_hz, frame_hz=10.0, g_norm=9.81)

    t0 = time.perf_counter()
    run = driver.run(est, n_frames=args.frames, pix_noise=args.pix_noise / 460.0)
    wall = time.perf_counter() - t0

    kinds = [e["kind"] for e in run.events]
    err = ate_rmse(run)
    out = {
        "frames": args.frames,
        "initialized": "initialized" in kinds,
        "steady_state": est.solver_flag == NON_LINEAR,
        "ate_rmse_m": round(float(err), 4),
        "wall_s": round(wall, 2),
        "frames_per_s": round(args.frames / wall, 2),
    }
    print(json.dumps(out), flush=True)
    if not out["initialized"] or err > ATE_MAX_M:
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
