"""The corrupted-initialization 6 s proxy of `chip_smoke.py` phase 11e
(tests/test_init_health.py:45-72), corrupted and not, in the port's proxy
room and in the JAX proxy's, beside the runs that tell where a run's
error comes from.

`--device cuda` (a CUDA card): the port's pipeline (`sim/proxy.
make_pipeline`: loop closure off, float64, graphed) on the frames rendered
on the card, as phase 11e runs, and on the same scene's frames rendered
on the CPU and copied to the card.  `--device cpu`: the JAX pipeline
(`vins_tpu/sim/proxy.make_pipeline`, float64) and the port's pipeline on
the CPU, with its own RANSAC draws and with the JAX pipeline's (the
tracker's `PRNGKey(42)` split every frame, the initializer's `PRNGKey(0)`
split per essential solve, as `tests/test_torch_pipeline.py` injects
them), on the same CPU-rendered frames.  The IMU samples and the pixel
noise are the same draws on every device (`proxy_inputs`).

The reference cannot run on the card, so the card's own frames reach it
through files: `--device cuda --save-card-frames DIR --part K` writes half
K (0, 1) of the JAX room's card-rendered run to DIR (float32 frames, and
with K = 0 the IMU and ground truth: 43 MB a half) and runs nothing else;
`--device cpu --card-frames DIR` runs the three CPU pipelines on those
frames in place of the CPU-rendered ones.

With `corrupted` the first accepted initialization gets 3× its positions,
velocities and scale, as the JAX test does.  Prints, per run, one line
`DIAG {json}`: failures, reboots by the health monitor, the published
frame of initialization, the SE(3) ATE over the whole run and over its
second half, the ratio of estimated to true step length over the first and
last 5 VIO frames (the scale the run carries) and the 12 post-init window
costs the health monitor reads.

    python3 tools/port_init_health_diagnose.py --device cuda   # ~2 min on an H100
    python tools/port_init_health_diagnose.py --device cpu     # ~15 min
    python3 tools/port_init_health_diagnose.py --device cuda --save-card-frames DIR --part 0
    python3 tools/port_init_health_diagnose.py --device cuda --save-card-frames DIR --part 1
    python tools/port_init_health_diagnose.py --device cpu --card-frames DIR   # ~6 min
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def corrupt_first_init(est) -> list:
    """Give `est`'s first accepted initialization 3× its p, v and scale
    (either package's estimator); returns a one-item count."""
    orig, n = est.initializer.try_initialize, [0]

    def corrupting(*a, **k):
        res = orig(*a, **k)
        if res.ok and n[0] == 0:
            n[0] += 1
            return res._replace(p=res.p * 3.0, v=res.v * 3.0, scale=res.scale * 3.0)
        return res

    est.initializer.try_initialize = corrupting
    return n


class JaxDraws:
    """The JAX pipeline's RANSAC draws, for the port's pipeline: the
    tracker's per-frame key (PRNGKey(42), split every frame) and the
    initializer's (PRNGKey(0), split per essential solve)."""

    def __init__(self, M: int):
        import jax

        self.M = M
        self.track = jax.random.PRNGKey(42)
        self.init = jax.random.PRNGKey(0)

    def frame(self):
        import jax
        import jax.numpy as jnp

        from vins_tpu_torch.frontend.tracker import N_HYP

        self.track, sub = jax.random.split(self.track)
        return np.asarray(jax.random.gumbel(sub, (N_HYP, self.M), jnp.float32))

    def initializer(self, shape):
        import jax
        import jax.numpy as jnp
        import torch

        self.init, sub = jax.random.split(self.init)
        return torch.from_numpy(np.asarray(jax.random.gumbel(sub, shape, jnp.float32)))


def run(pipe, inp, frames, corrupted: bool, draws: JaxDraws | None = None) -> dict:
    """Feed `inp`'s IMU and `frames` to `pipe` (either package's pipeline)
    as `run_proxy` does, with `draws` for the port's RANSAC when given, and
    summarize."""
    from vins_tpu_torch.sim.proxy import ate_rmse_tum

    est = pipe.estimator
    n = corrupt_first_init(est) if corrupted else [0]
    if draws is not None:
        est.initializer.gumbel = draws.initializer
    t0 = time.perf_counter()
    kinds = []
    for fi, t in enumerate(inp.t):
        if fi > 0:
            for ti, a, w in zip(inp.imu_t[fi - 1], inp.acc[fi - 1], inp.gyr[fi - 1]):
                pipe.process_imu(float(ti), a, w)
        kw = {} if draws is None else {"gumbel": draws.frame()}
        ev = pipe.process_image(frames[fi], float(t), **kw)
        if ev.get("published"):
            kinds.append(ev.get("kind"))
    pipe.pg_join()
    pipe.shutdown()
    traj = pipe.trajectory
    P = np.stack([p for _, p, _ in traj])
    G = inp.p_gt[np.clip(np.searchsorted(inp.t, [t for t, _, _ in traj]), 0, len(inp.t) - 1)]
    step = (np.linalg.norm(np.diff(P, axis=0), axis=1)
            / np.maximum(np.linalg.norm(np.diff(G, axis=0), axis=1), 1e-9))
    return dict(corrupted_inits=n[0], failures=int(est.failures),
                health_reboots=int(est.init_rejected_by_health),
                init_published=kinds.index("initialized") if "initialized" in kinds else None,
                ate_m=ate_rmse_tum(traj, inp.t, inp.p_gt),
                ate_second_half_m=ate_rmse_tum(traj[len(traj) // 2:], inp.t, inp.p_gt),
                step_scale_first5=np.round(step[:5], 3).tolist(),
                step_scale_last5=np.round(step[-5:], 3).tolist(),
                post_init_costs=[round(float(c), 1) for c in est._post_init_costs],
                seconds=time.perf_counter() - t0)


STORED = ("t", "p_gt", "q_gt", "imu_t", "acc", "gyr")


def save_card_frames(inp, out_dir: str, part: int) -> None:
    half = len(inp.t) // 2
    frames = inp.frames[:half] if part == 0 else inp.frames[half:]
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"card_frames_{part}.npz")
    np.savez(path, frames=np.stack([f.cpu().numpy() for f in frames]),
             **({k: getattr(inp, k) for k in STORED} if part == 0 else {}))
    print(f"wrote {path}", flush=True)


def stored_inputs(in_dir: str):
    """The card-rendered run that `save_card_frames` wrote, as `ProxyInputs`
    on the CPU."""
    import torch

    from vins_tpu_torch.sim.proxy import ProxyInputs

    a, b = (np.load(os.path.join(in_dir, f"card_frames_{k}.npz")) for k in (0, 1))
    frames = [torch.from_numpy(f) for f in np.concatenate([a["frames"], b["frames"]])]
    return ProxyInputs(frames=frames, **{k: a[k] for k in STORED})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--save-card-frames", metavar="DIR")
    ap.add_argument("--part", type=int, default=0, choices=(0, 1))
    ap.add_argument("--card-frames", metavar="DIR")
    args = ap.parse_args()

    import torch

    from vins_tpu_torch.sim import proxy

    # (name, render device, the frames' form for the pipeline, the pipeline,
    # JAX's draws for the port)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("port_init_health_diagnose: no CUDA device is visible")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if args.save_card_frames:
            inp = proxy.proxy_inputs(duration=args.seconds, device="cuda",
                                     room=proxy.jax_proxy_room("cuda"))
            save_card_frames(inp, args.save_card_frames, args.part)
            return 0
        port = lambda: proxy.make_pipeline(device="cuda", loop_closure=False)  # noqa: E731
        cases = [("port_card", "cuda", "cuda", port, False),
                 ("port_card_cpu_frames", "cpu", "cuda", port, False)]
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp

        from vins_tpu.sim import proxy as jproxy

        torch.set_num_threads(8)
        port = lambda: proxy.make_pipeline(device="cpu", loop_closure=False)  # noqa: E731
        cases = [("jax_cpu", "cpu", "numpy",
                  lambda: jproxy.make_pipeline(loop_closure=False, dtype=jnp.float64), False),
                 ("port_cpu", "cpu", "cpu", port, False),
                 ("port_cpu_jax_draws", "cpu", "cpu", port, True)]
        if args.card_frames:
            cases = [(name + "_card_frames", "stored", form, make, jd)
                     for name, _, form, make, jd in cases]

    for room in ("jax",) if args.card_frames else ("port", "jax"):
        for name, render, form, make, jax_draws in cases:
            if render == "stored":
                inp = stored_inputs(args.card_frames)
            else:
                inp = proxy.proxy_inputs(duration=args.seconds, device=render,
                                         room=proxy.jax_proxy_room(render) if room == "jax"
                                         else None)
            frames = [f.numpy() if form == "numpy" else f.to(form) for f in inp.frames]
            for corrupted in (True, False):
                pipe = make()
                draws = JaxDraws(pipe.cfg.max_cnt) if jax_draws else None
                r = run(pipe, inp, frames, corrupted, draws)
                print("DIAG " + json.dumps(dict(room=room, run=name, corrupted=corrupted, **r)),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
