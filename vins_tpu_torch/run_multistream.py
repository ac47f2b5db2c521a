"""Batched multi-stream proxy replay: S independent textured-room streams
through `parallel.multistream.MultiPipeline` on one card.

Counterpart of `tools/run_multistream.py` (the JAX package's aggregate
throughput run).  Each stream has its own room texture (`Room.make(100 +
s)`), circuit geometry (radius 3.8 + 0.1 s m, period 14 + 0.5 s seconds,
height 1.0 + 0.05 s m), IMU noise (`np.random.default_rng(s)`) and pixel
noise (a CPU `torch.Generator` seeded 200 + s); each stream's ATE is scored
against its own closed-form ground truth.  The estimators run in float32,
as the JAX driver's do.

    python -m vins_tpu_torch.run_multistream [--streams 8] [--duration 20]
        [--no-loop] [--out FILE] [--device cuda|cpu]

The last line of standard output is one JSON object: streams,
aggregate_fps, per_stream_fps, ate_per_stream_m, loops_per_stream, reboots,
frames_timed.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .parallel.multistream import MultiPipeline
from .sim.proxy import BA, BG, EUROC_H, EUROC_W, TIC, ate_rmse_tum, euroc_camera, make_pipeline
from .sim.render import Room, RoomRenderer
from .sim.synthetic import Trajectory
from .sim.window import R_IC_FORWARD

IMU_HZ = 200.0


def generate_streams(S: int, duration: float, frame_hz: float = 20.0,
                     loop_closure: bool = True, pg_async: bool = True,
                     pix_noise: float = 2.0, device="cuda", dtype=torch.float32):
    """The MultiPipeline and its pre-generated sensor data.

    Returns (mp, frames, gt): frames is a list of (t, imu_per_stream, imgs
    [S,H,W] on `device`), imu_per_stream[s] the (t, acc, gyr) samples since
    the previous frame, and gt[s] = (ts, p, q).  The pipelines are the
    proxy's (`sim/proxy.make_pipeline`) with a `dtype` estimator (the JAX
    driver's float32 by default) and the driver's sparse keyframe cadence
    (pg_skip_first_cnt 5, pg_skip_cnt 2, pg_skip_dis 0.2 m); each stream's
    own estimator runs its initialization eagerly (one step per
    initialization does not pay for two graph captures), the batched step
    is one CUDA graph."""
    mp = MultiPipeline(
        lambda s: make_pipeline(device=device, loop_closure=loop_closure, dtype=dtype,
                                pg_async=pg_async, pg_skip_first_cnt=5, pg_skip_cnt=2,
                                pg_skip_dis=0.2, cuda_graph=False),
        S, loop_closure=loop_closure)

    trajs = [Trajectory.circuit(radius=3.8 + 0.1 * s, period=14.0 + 0.5 * s,
                                height=1.0 + 0.05 * s) for s in range(S)]
    gravity = torch.tensor([0.0, 0.0, 9.81], dtype=torch.float64)
    cam = euroc_camera(device=device)
    renderers = [RoomRenderer(cam, EUROC_H, EUROC_W, room=Room.make(100 + s, device=device),
                              tic=TIC, Ric=np.asarray(R_IC_FORWARD)) for s in range(S)]
    gens = [torch.Generator().manual_seed(200 + s) for s in range(S)]
    rngs = [np.random.default_rng(s) for s in range(S)]

    dt_i = 1.0 / IMU_HZ
    sig_a, sig_g = 0.02 * np.sqrt(IMU_HZ), 0.0017 * np.sqrt(IMU_HZ)
    wba, wbg = 0.0004 * np.sqrt(dt_i), 2e-5 * np.sqrt(dt_i)
    n_frames = int(round(duration * frame_hz))
    n_sub = int(round(IMU_HZ / frame_hz))
    frame_ts = 1.0 + np.arange(n_frames) / frame_hz
    imu_ts = (np.concatenate([frame_ts[fi - 1] + np.arange(1, n_sub + 1) * dt_i
                              for fi in range(1, n_frames)])
              if n_frames > 1 else np.zeros(0))

    # per stream, the clean IMU at every sample time and the poses at every
    # frame time in one batched call each; then noise and bias random walks
    noisy_imu, poses = [], []
    for s in range(S):
        A, Wg = (x.numpy() for x in trajs[s].imu_at_times(torch.from_numpy(imu_ts), gravity))
        P = np.stack([trajs[s].pos_fn(t).numpy() for t in frame_ts])
        Q = np.stack([trajs[s].q(t).numpy() for t in frame_ts])
        poses.append((P, Q))
        n = len(imu_ts)
        ba = np.asarray(BA)[None] + np.cumsum(wba * rngs[s].standard_normal((n, 3)), 0)
        bg = np.asarray(BG)[None] + np.cumsum(wbg * rngs[s].standard_normal((n, 3)), 0)
        acc = A + ba + sig_a * rngs[s].standard_normal((n, 3))
        gyr = Wg + bg + sig_g * rngs[s].standard_normal((n, 3))
        noisy_imu.append((acc, gyr))

    frames = []
    gt = [([], [], []) for _ in range(S)]
    for fi, t in enumerate(frame_ts):
        imu_per_stream = []
        for s in range(S):
            o = (fi - 1) * n_sub
            imu_per_stream.append(
                [(imu_ts[o + k], noisy_imu[s][0][o + k], noisy_imu[s][1][o + k])
                 for k in range(n_sub)] if fi > 0 else [])
        imgs = []
        for s in range(S):
            P, Q = poses[s]
            img = renderers[s].render_device(torch.from_numpy(P[fi]), torch.from_numpy(Q[fi]))
            if pix_noise > 0:
                noise = pix_noise * torch.randn((EUROC_H, EUROC_W), generator=gens[s])
                img = torch.clamp(img + noise.to(img.device), 0.0, 255.0)
            imgs.append(img)
            gt[s][0].append(t)
            gt[s][1].append(P[fi])
            gt[s][2].append(Q[fi])
        frames.append((float(t), imu_per_stream, torch.stack(imgs)))
    return mp, frames, gt


def drive(mp: MultiPipeline, frames, frame_hz: float = 20.0, publish_hz: float = 10.0,
          start: int = 0, end: int | None = None) -> float:
    """Feed pre-generated frames, publishing at `publish_hz` (the frequency
    controller's downsampling).  Returns the elapsed seconds."""
    every = max(1, int(round(frame_hz / publish_hz)))
    end = len(frames) if end is None else min(end, len(frames))
    t0 = time.perf_counter()
    for fi in range(start, end):
        t, imu_per_stream, imgs = frames[fi]
        for s, samples in enumerate(imu_per_stream):
            for ti, a, w in samples:
                mp.process_imu(s, ti, a, w)
        publish = (fi % every) == 0
        if publish:
            for s in range(mp.S):
                mp.push_image_ring(s, t, imgs[s])
        mp.process_images(imgs, t, publish=publish)
    return time.perf_counter() - t0


def warm_up(mp: MultiPipeline, frames, **kw) -> int:
    """The JAX driver's warm-up: min(60, n/3) frames, then 10 more at a time
    until every stream has initialized (or 2n/3 frames).  Returns the first
    frame of the timed segment."""
    n = len(frames)
    warm = min(60, n // 3)
    drive(mp, frames, start=0, end=warm, **kw)
    while warm < 2 * n // 3 and not all(p.estimator.solver_flag == 1 for p in mp.pipes):
        drive(mp, frames, start=warm, end=warm + 10, **kw)
        warm = min(warm + 10, n)
    return warm


def summary(mp: MultiPipeline, gt, agg_fps: float, frames_timed: int) -> dict:
    """The JAX driver's result line (call after `mp.finish()`)."""
    S = mp.S
    ates = [ate_rmse_tum(mp.pipes[s].trajectory, np.asarray(gt[s][0]), np.stack(gt[s][1]))
            for s in range(S)]
    return {
        "streams": S,
        "aggregate_fps": round(agg_fps, 2),
        "per_stream_fps": round(agg_fps / S, 2),
        "ate_per_stream_m": [round(a, 3) for a in ates],
        "loops_per_stream": [sum(1 for e in p.pg_events if e.get("loop") is not None)
                             for p in mp.pipes],
        "reboots": [p.estimator.failures for p in mp.pipes],
        "frames_timed": frames_timed,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="S textured-room streams through MultiPipeline.")
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        # the float32 estimator's matmuls in full float32, as the JAX driver
        # asks for the highest matmul precision
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    S = args.streams
    print(f"generating {S} streams x {args.duration}s ...", flush=True)
    mp, frames, gt = generate_streams(S, args.duration, loop_closure=not args.no_loop,
                                      device=args.device)
    n = len(frames)
    warm = warm_up(mp, frames)
    n_init = sum(p.estimator.solver_flag == 1 for p in mp.pipes)
    print(f"timed segment (from frame {warm}; {n_init}/{S} initialized) ...", flush=True)
    mp.tracer.stats.reset()
    dt = drive(mp, frames, start=warm, end=n)
    agg_fps = S * (n - warm) / dt if n > warm else 0.0
    print(mp.tracer.stats.report(), flush=True)
    mp.finish()
    out = summary(mp, gt, agg_fps, n - warm)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
