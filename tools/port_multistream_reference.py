"""The JAX multi-stream pipeline against the port's on the same inputs (CPU).

Renders two streams of `vins_tpu_torch.run_multistream.generate_streams`'s
scene with the port on the CPU (each stream its own room, circuit, IMU and
pixel noise; frames at 10 Hz, all published, as tests/test_multistream.py
runs the JAX driver), and feeds the same frames (as numpy) and IMU samples
to `vins_tpu.parallel.multistream.MultiPipeline` and to the port's
`vins_tpu_torch.parallel.multistream.MultiPipeline`, both float64 with loop
closure off.  The port gets the JAX run's RANSAC draws: each JAX tracker's
key sequence (PRNGKey(42), split every tick) and each JAX initializer's
(PRNGKey(0), split per essential solve).

Prints, per stream, both runs' estimator events, failures, ATE (SE(3),
`ate_rmse_tum`) and the largest difference of the two trajectories after an
SE(3) alignment (each estimator fixes its own gauge at initialization), as
one JSON line.  tests/test_torch_pipeline.py holds the single-stream
pipelines to 0.3 m by the same measure.

    python tools/port_multistream_reference.py [--seconds 6] [--streams 2]
        [--frame-hz 10] [--publish-hz 10] [--pix-noise 2] [--float32] [--skip-port]

`--frame-hz 20 --publish-hz 10 --float32 --streams 8 --seconds 12
--skip-port` gives the JAX run of `chip_smoke.py` phase 9b's inputs (the
JAX driver's settings), whose ATE per stream sets 9b's bound.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def aligned_max_dp(ta, tb) -> float:
    """Largest |Δp| of two trajectories [(t, p, q)] over their common stamps
    after the SE(3) alignment of the second onto the first."""
    pa = {round(t, 6): p for t, p, _ in ta}
    common = [(pa[round(t, 6)], p) for t, p, _ in tb if round(t, 6) in pa]
    if len(common) < 3:
        return float("nan")
    G = np.stack([a for a, _ in common])
    P = np.stack([b for _, b in common])
    Gc, Pc = G - G.mean(0), P - P.mean(0)
    U, _, Vt = np.linalg.svd(Gc.T @ Pc)
    R = U @ np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    return float(np.linalg.norm(Pc @ R.T - Gc, axis=1).max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--streams", type=int, default=2)
    ap.add_argument("--frame-hz", type=float, default=10.0)
    ap.add_argument("--publish-hz", type=float, default=None)
    ap.add_argument("--pix-noise", type=float, default=2.0)
    ap.add_argument("--float32", action="store_true", help="both estimators in float32")
    ap.add_argument("--skip-port", action="store_true", help="the JAX run only")
    args = ap.parse_args()
    every = max(1, int(round(args.frame_hz / (args.publish_hz or args.frame_hz))))

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from vins_tpu.parallel.multistream import MultiPipeline as JMulti
    from vins_tpu.sim import proxy as jproxy
    from vins_tpu_torch import run_multistream
    from vins_tpu_torch.frontend.tracker import N_HYP
    from vins_tpu_torch.parallel.multistream import MultiPipeline as TMulti
    from vins_tpu_torch.sim import proxy as tproxy

    torch.set_num_threads(8)
    S = args.streams
    t0 = time.perf_counter()
    _, frames, gt = run_multistream.generate_streams(S, args.seconds, frame_hz=args.frame_hz,
                                                     loop_closure=False, pg_async=False,
                                                     pix_noise=args.pix_noise, device="cpu")
    print(f"inputs: {len(frames)} ticks x {S} streams in {time.perf_counter() - t0:.1f} s",
          flush=True)

    jdt, tdt = (jnp.float32, torch.float32) if args.float32 else (jnp.float64, torch.float64)
    jmp = JMulti(lambda s: jproxy.make_pipeline(loop_closure=False, dtype=jdt), S,
                 loop_closure=False)

    def port_pipe(s):
        pipe = tproxy.make_pipeline(device="cpu", loop_closure=False, dtype=tdt)
        key = [jax.random.PRNGKey(0)]

        def draw(shape):
            key[0], sub = jax.random.split(key[0])
            return torch.from_numpy(np.asarray(jax.random.gumbel(sub, shape, jnp.float32)))

        pipe.estimator.initializer.gumbel = draw
        return pipe

    tmp = None if args.skip_port else TMulti(port_pipe, S, loop_closure=False)
    keys = [jax.random.PRNGKey(42) for _ in range(S)]  # the JAX trackers' sequences
    M = jmp.pipes[0].tracker.M
    jev, tev = [[] for _ in range(S)], [[] for _ in range(S)]
    t1 = time.perf_counter()
    for fi, (t, imu, imgs) in enumerate(frames):
        publish = fi % every == 0
        for s, samples in enumerate(imu):
            for ti, a, w in samples:
                jmp.process_imu(s, ti, a, w)
                if tmp is not None:
                    tmp.process_imu(s, ti, a, w)
        subs = []
        for s in range(S):
            keys[s], sub = jax.random.split(keys[s])
            subs.append(sub)
        host = imgs.numpy()
        runs = [(jev, jmp.process_images(jnp.asarray(host), t, publish=publish))]
        if tmp is not None:
            gum = np.stack([np.asarray(jax.random.gumbel(k, (N_HYP, M), jnp.float32))
                            for k in subs])
            runs.append((tev, tmp.process_images(torch.from_numpy(host), t, publish=publish,
                                                 gumbel=gum)))
        for out, ev in runs:
            for s, e in enumerate(ev):
                if e is not None and "kind" in e:
                    out[s].append(e["kind"])
    jmp.finish()
    if tmp is not None:
        tmp.finish()
    run_s = time.perf_counter() - t1

    streams = []
    for s in range(S):
        ts, ps = np.asarray(gt[s][0]), np.stack(gt[s][1])
        jp = jmp.pipes[s]
        out = dict(jax_events=jev[s], jax_failures=int(jp.estimator.failures),
                   jax_ate_m=tproxy.ate_rmse_tum(jp.trajectory, ts, ps),
                   jax_first_pose_t=jp.trajectory[0][0] if jp.trajectory else None)
        if tmp is not None:
            tp = tmp.pipes[s]
            out.update(port_events=tev[s], port_failures=int(tp.estimator.failures),
                       port_ate_m=tproxy.ate_rmse_tum(tp.trajectory, ts, ps),
                       poses=[len(jp.trajectory), len(tp.trajectory)],
                       max_dp_aligned_m=aligned_max_dp(jp.trajectory, tp.trajectory))
        streams.append(out)
    print(json.dumps(dict(vars(args), streams=streams, run_s=run_s)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
