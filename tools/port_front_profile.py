"""Where the port's front-end time goes on one CUDA card.

Runs `vins_tpu_torch.frontend.tracker.FeatureTracker.read_image` over the
proxy sequence of `chip_smoke.py` (752×480, 150 slots, publish on every
second frame) and profiles frames 20-39 one at a time with torch.profiler.
For published and for track-only frames it reports the median wall time
(CUDA events around the call), the device kernels launched, their summed
device time, the device's idle share (1 − kernel time / wall time), the
kernels that take the most device time, and the most host syncs (runtime
calls that wait for the device) and device-to-host and host-to-device
copies seen on one frame.  Prints one JSON object.

    python3 tools/port_front_profile.py     (needs a CUDA device)
"""
from __future__ import annotations

import collections
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
COUNTS = ("host_syncs", "dtoh_copies", "htod_copies")


def main():
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("port_front_profile: no CUDA device is visible")
    sys.path.insert(0, ROOT)
    from vins_tpu_torch.frontend.tracker import FeatureTracker
    from vins_tpu_torch.sim import proxy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    seq = proxy.render_sequence(40, device=dev)
    tr = FeatureTracker(proxy.euroc_camera(device=dev), max_cnt=150, min_dist=30,
                        f_threshold=1.0, equalize=True, focal=proxy.FOCAL, device=dev)
    stats = {k: collections.defaultdict(list) for k in ("published", "track_only")}
    per_kernel = {k: collections.Counter() for k in stats}
    sync_sites = {k: collections.Counter() for k in stats}
    for i, (t, img) in enumerate(zip(seq.t, seq.frames)):
        publish = i % 2 == 0
        if i < 20:  # warm-up: library loads, allocator, cuBLAS/cuSOLVER handles
            tr.read_image(img, float(t), publish=publish)
            continue
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            tr.read_image(img, float(t), publish=publish)
            end.record()
            end.synchronize()
        kind = "published" if publish else "track_only"
        events = prof.events()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.device_time for e in kernels)
        wall_ms = start.elapsed_time(end)
        s = stats[kind]
        s["wall_ms"].append(wall_ms)
        s["device_events"].append(len(kernels))
        s["device_busy_ms"].append(busy_us / 1e3)
        s["idle_share"].append(1.0 - busy_us / 1e3 / wall_ms)
        # runtime calls that block the host on the device, less this tool's
        # own two: the cudaEventSynchronize of `end` above and the
        # profiler's cudaDeviceSynchronize, neither inside a torch op
        syncs = [e for e in events if e.device_type != DeviceType.CUDA and e.name in HOST_SYNCS]
        s["host_syncs"].append(len(syncs) - 2)
        for e in syncs:
            chain, p = [e.name], e.cpu_parent
            while p is not None and len(chain) < 4:
                chain.append(p.name)
                p = p.cpu_parent
            sync_sites[kind][" <- ".join(chain)] += 1
        s["dtoh_copies"].append(sum(e.name.startswith("Memcpy DtoH") for e in kernels))
        s["htod_copies"].append(sum(e.name.startswith("Memcpy HtoD") for e in kernels))
        for e in kernels:
            per_kernel[kind][e.name] += e.device_time
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"card": card, "frames": "20-39"}
    for kind, s in stats.items():
        n = len(s["wall_ms"])
        out[kind] = {k: float(np.median(v)) for k, v in s.items() if k not in COUNTS}
        out[kind].update({f"max_{k}": int(max(s[k])) for k in COUNTS})
        out[kind]["n_frames"] = n
        out[kind]["host_syncs_per_frame_by_site"] = {
            site: c / n for site, c in sync_sites[kind].most_common()}
        out[kind]["top_kernels_us_per_frame"] = [
            [name[:90], round(us / n, 2)] for name, us in per_kernel[kind].most_common(12)]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
