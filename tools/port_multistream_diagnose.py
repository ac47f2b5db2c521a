"""Per-stream accuracy of the port's multi-stream run on the card, by
estimator dtype.

Runs `chip_smoke.py` phase 9b's inputs (`vins_tpu_torch.run_multistream`:
8 streams, 12 s, frames at 20 Hz published at 10 Hz, loop closure off)
with float32 estimators (the JAX driver's) and again with float64 ones,
the same frames and draws, and prints per stream the SE(3) ATE over the
whole run and up to t = 7 s, the stamp of the first pose and the failures,
one JSON line per dtype.  It separates a drift that float32 rounding
causes from one both precisions share.

    python3 tools/port_multistream_diagnose.py [--streams 8] [--seconds 12]   # on a CUDA card
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    from vins_tpu_torch import run_multistream as rm
    from vins_tpu_torch.sim.proxy import ate_rmse_tum

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        mp, frames, gt = rm.generate_streams(args.streams, args.seconds, loop_closure=False,
                                             device=args.device, dtype=dtype)
        rm.drive(mp, frames)
        mp.finish()
        streams = []
        for s, pipe in enumerate(mp.pipes):
            ts, ps = np.asarray(gt[s][0]), np.stack(gt[s][1])
            traj = pipe.trajectory
            streams.append(dict(
                ate_m=ate_rmse_tum(traj, ts, ps),
                ate_to_7s_m=ate_rmse_tum([e for e in traj if e[0] < 7.0], ts, ps),
                first_pose_t=traj[0][0] if traj else None, poses=len(traj),
                failures=pipe.estimator.failures))
        print(json.dumps(dict(dtype=str(dtype), seconds=args.seconds, streams=streams,
                              run_s=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
