"""The JAX estimator's numbers on the scene of `chip_smoke.py` phase 11d
(CPU, float64): ESTIMATE_EXTRINSIC = 2 on the figure-8 of period 5 s.

The JAX `Estimator` (`tools/run_synthetic.py`'s config with
`estimate_extrinsic=2`) runs 60 frames of the JAX `SyntheticDriver` on
that trajectory with the driver's own landmarks (`PRNGKey(0)`), and the
port's `Estimator` on the CPU runs the port's driver on the same landmarks
(`sim/driver.jax_driver_points`), as phase 11d does on the card; beside
them the JAX run on the port driver's own landmarks (a generator seeded
0), where the reference's initialization takes the all-frames path at a
wrong scale (ROADMAP Queue 3).  Each goes through
`chip_smoke.calibrated_run`.  For each: the frame
that accepted the calibration, the calibrated rotation's angle from
R_IC_FORWARD as accepted (before that frame's initialization and VIO
step), the frame and kind of the initialization and its scale, the final
solver flag, failures and the yaw-aligned ATE.
The phase-11d limits in `chip_smoke.py` come from these numbers.

    python tools/port_synthetic_reference.py [--frames 60] [--period 5]

Prints one JSON line (~2 min).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--period", type=float, default=5.0)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from chip_smoke import calibrated_run
    from vins_tpu.config import VinsConfig as JConfig
    from vins_tpu.estimator.estimator import Estimator as JEstimator
    from vins_tpu.sim import driver as jdriver
    from vins_tpu.sim.synthetic import Trajectory as JTrajectory
    from vins_tpu.sim.window import R_IC_FORWARD
    from vins_tpu_torch import run_synthetic
    from vins_tpu_torch.sim import driver as tdriver
    from vins_tpu_torch.sim.synthetic import Trajectory as TTrajectory

    torch.set_num_threads(8)
    port_points = tdriver.SyntheticDriver().points.numpy()
    out = {"frames": args.frames, "period_s": args.period}
    for name in ("jax_own_landmarks", "port_cpu", "jax_port_landmarks"):
        if name == "port_cpu":
            est = run_synthetic.make_estimator("cpu", estimate_extrinsic=2)
            driver = tdriver.SyntheticDriver(traj=TTrajectory.figure8(period=args.period))
            driver.points = tdriver.jax_driver_points()
        else:
            est = JEstimator(JConfig(max_landmarks=160, g_norm=9.81, extrinsic_R=R_IC_FORWARD,
                                     extrinsic_t=(0.06, -0.01, 0.02), estimate_extrinsic=2),
                             imu_buf_len=64)
            driver = jdriver.SyntheticDriver(imu_hz=200.0, frame_hz=10.0, g_norm=9.81,
                                             traj=JTrajectory.figure8(period=args.period))
            if name == "jax_port_landmarks":
                driver.points = jnp.asarray(port_points)  # read when _frame_at first traces
        out[name] = calibrated_run(est, driver, args.frames)
        out[name].pop("kinds")
        print(f"{name}: " + json.dumps(out[name]), file=sys.stderr, flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
