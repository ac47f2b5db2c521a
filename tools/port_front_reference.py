"""Front-end tracking quality of the JAX tracker on the port's proxy frames.

Renders the sequence that `chip_smoke.py` tracks on the GPU (the textured
room along Trajectory.circuit, 752×480, EuRoC camera, pixel noise σ = 2;
`vins_tpu_torch.sim.proxy.render_sequence`) on the CPU, and runs it through
the JAX `FeatureTracker` (the reference) and the port's tracker on the CPU
(plain LK), publishing every second frame.  Prints one JSON object with the
per-frame published counts and the ground-truth epipolar (Sampson) error of
the published tracks for both; `chip_smoke.py` takes its phase-3 limits
from the JAX numbers.

    python tools/port_front_reference.py
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from vins_tpu.core.cameras import PinholeCamera as JPinhole
    from vins_tpu.frontend.tracker import FeatureTracker as JTracker
    from vins_tpu_torch.frontend.tracker import FeatureTracker
    from vins_tpu_torch.sim import proxy

    torch.set_num_threads(4)
    t0 = time.perf_counter()
    seq = proxy.render_sequence(60, device="cpu")
    frames = [f.numpy() for f in seq.frames]
    t_render = time.perf_counter() - t0
    front = dict(max_cnt=150, min_dist=30, f_threshold=1.0, equalize=True, focal=460.0)

    def run(tracker):
        published = {}
        for i, (t, img) in enumerate(zip(seq.t, frames)):
            out = tracker.read_image(img, float(t), publish=(i % 2 == 0))
            if out is not None:
                published[i] = out
        return proxy.track_quality(seq, published)

    result = {}
    t0 = time.perf_counter()
    result["jax_cpu"] = run(JTracker(JPinhole.create(**proxy.EUROC_INTRINSICS,
                                                     dtype=jnp.float32), **front))
    result["jax_cpu"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    result["port_cpu"] = run(FeatureTracker(proxy.euroc_camera(device="cpu"), **front,
                                            device="cpu"))
    result["port_cpu"]["seconds"] = time.perf_counter() - t0
    result["render_seconds"] = t_render
    print(json.dumps(result))


if __name__ == "__main__":
    main()
