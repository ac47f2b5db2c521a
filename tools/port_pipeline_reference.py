"""The JAX pipeline's numbers on the port's proxy inputs (CPU, float64).

Renders the inputs of `chip_smoke.py` phase 5 with the port
(`vins_tpu_torch.sim.proxy.proxy_inputs` on the CPU: 10 s of the textured
room at 10 Hz, 752×480, pixel noise σ = 2, a 200 Hz noisy biased IMU from
`np.random.default_rng(0)`), feeds the same frames (as numpy) and the same
IMU samples to the JAX `Pipeline` (serial, loop closure off, the proxy
config of `vins_tpu/sim/proxy.py`), and prints its frame of
initialization, event kinds, failures and ATE (SE(3), `ate_rmse_tum`).
The port's `Pipeline` on the CPU runs the same inputs beside it.  The
phase-5 limits in `chip_smoke.LIMITS` come from these numbers.

    python tools/port_pipeline_reference.py [--seconds 10]

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


def summarize(kinds, run_t, traj, t_gt, p_gt, failures, ate_fn) -> dict:
    pub = [k for k in kinds if k is not None]
    i0 = pub.index("initialized") if "initialized" in pub else None
    return dict(
        init_published_index=i0,
        init_time=None if i0 is None else float(run_t[i0]),
        n_published=len(pub),
        kinds_after_init=sorted(set(pub[i0 + 1:])) if i0 is not None else [],
        n_vio=pub.count("vio"),
        failures=int(failures),
        ate_se3_m=ate_fn(traj, t_gt, p_gt),
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from vins_tpu.sim import proxy as jproxy
    from vins_tpu_torch.sim import proxy as tproxy

    t0 = time.perf_counter()
    inp = tproxy.proxy_inputs(duration=args.seconds, device="cpu")
    t_render = time.perf_counter() - t0
    frames = [f.numpy() for f in inp.frames]
    out = {"seconds": args.seconds, "frames": len(frames), "render_s": t_render}

    for name in ("jax", "port_cpu"):
        t0 = time.perf_counter()
        if name == "jax":
            pipe = jproxy.make_pipeline(loop_closure=False, dtype=jnp.float64)
        else:
            pipe = tproxy.make_pipeline(device="cpu", loop_closure=False)
        kinds, pub_t = [], []
        for fi, t in enumerate(inp.t):
            if fi > 0:
                for ti, a, w in zip(inp.imu_t[fi - 1], inp.acc[fi - 1], inp.gyr[fi - 1]):
                    pipe.process_imu(float(ti), a, w)
            img = frames[fi] if name == "jax" else torch.from_numpy(frames[fi])
            ev = pipe.process_image(img, float(t))
            if ev.get("published"):
                kinds.append(ev.get("kind"))
                pub_t.append(float(t))
        j = np.searchsorted(inp.t, pub_t)
        s = summarize(kinds, np.asarray(pub_t), pipe.trajectory, inp.t, inp.p_gt,
                      pipe.estimator.failures, jproxy.ate_rmse_tum)
        s["run_s"] = time.perf_counter() - t0
        s["published_frames"] = [int(x) for x in j]
        s["kinds"] = kinds
        out[name] = s
        print(f"{name}: " + json.dumps({k: v for k, v in s.items() if k != "kinds"}),
              file=sys.stderr, flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
