#!/usr/bin/env python3
"""Smoke run of the vins_tpu_torch port on one CUDA card.

Phases (any failure exits non-zero; nothing is caught and carried on):
  0. require a CUDA device; TF32 off for matmuls and convolutions;
  1. build every kernel from `vins_tpu_torch/csrc/` with nvcc;
  2. hold each kernel against its plain PyTorch version on the card, at
     the shapes of the main path;
  3. drive the main path, the front-end (`FeatureTracker.read_image`), over
     60 rendered 752×480 EuRoC-layout frames, publishing every second frame;
     check the kernels' launch counts, the published counts and the
     ground-truth epipolar error of the tracks against limits set from the
     JAX tracker's numbers (`tools/port_front_reference.py`), and the same
     run with the plain LK;
  4. time each kernel, its plain version and `read_image` (on frames already
     on the card and on 8-bit host frames) with CUDA events, and compute
     each kernel's bound from the work its inputs need.
Then it prints a `kernels` JSON line, the card's name and power limit, and
last `{"ok": true, "device": {...}}`.

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

WIN, ITERS, EPS, MIN_EIG = 21, 10, 0.01, 1e-4
N_FEAT = 150
N_FRAMES = 60
LEVEL_SHAPES = [(480, 752), (240, 376), (120, 188)]  # EuRoC pyramid, unpadded
SEARCH = {0: 10, 1: 10, 2: 32}  # per level on the main path (klt.lk_pyramidal)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, HBM3 peak
F32_FLOP_PER_S = 67e12          # H100 SXM, float32 outside the tensor cores

# Phase-3 limits, from the JAX tracker on the same 60 frames (rendered on
# the CPU, f32; tools/port_front_reference.py): mean 102.41 published
# features per published frame, Sampson error against the true pose median
# 0.0650 px, p90 0.2687 px, 0.0570 of tracks above 1 px.  Margins: the mean
# count may fall 15 % (the RANSAC draws differ from JAX's and the id
# decisions drift apart over 60 frames), the errors may grow by half.
LIMITS = dict(mean_count_min=0.85 * 102.41, sampson_median_max=1.5 * 0.0650,
              sampson_p90_max=1.5 * 0.2687, frac_over_1px_max=1.5 * 0.0570)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def device_ms(fn, runs: int = 25, warmup: int = 3, sleep_cycles: int = 0) -> float:
    """Median time of `fn` on the device, from CUDA events.  With
    `sleep_cycles`, a device sleep is queued first, so the whole call is
    enqueued before the device reaches the start event and the time is the
    device's own; without it, host gaps inside the call count."""
    import torch

    times = []
    for i in range(warmup + runs):
        torch.cuda.synchronize()
        if sleep_cycles:
            torch.cuda._sleep(sleep_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def union_pixels(Hp: int, Wp: int, y0, x0, P: int) -> int:
    """Pixels of an Hp×Wp image covered by P×P blocks at corners (y0, x0)."""
    import torch

    ar = torch.arange(P, device=y0.device)
    idx = (y0[:, None, None] + ar[None, :, None]) * Wp + x0[:, None, None] + ar[None, None, :]
    mask = torch.zeros(Hp * Wp, dtype=torch.bool, device=y0.device)
    mask[idx.reshape(-1)] = True
    return int(mask.sum())


def lk_bound_ms(args, search: int, win: int = WIN, iters: int = ITERS):
    """Least time for one LK level on these inputs: the larger of the bytes
    the function must move over the HBM rate and its float32 operations over
    the f32 peak.  Returns (ms, "bytes" or "operations", iterations needed).

    Bytes: each pixel it must read, once — the union of the (win+3)² img0
    template patches of the valid features, and the union of the (win+1)²
    img1 patches of the iterations that features passing the gate need (up
    to the one that freezes; later ones reread the same patch and change
    nothing) — plus p0, g, valid read and g_new, ok written.  Operations,
    with the bilinear weights hoisted per feature: per valid feature the
    (win+2)² template samples (7 each) and the win² gradients and G terms
    (10 each); per needed iteration win² samples, differences and two
    products (12 each).  The iterations' positions come from the plain
    version run with 0..iters iterations."""
    import torch

    from vins_tpu_torch.frontend.klt import _lk_level, floor_index, lk_search_radius

    img0, img1, p0, g, valid = args
    Hp, Wp = img0.shape
    n = p0.shape[0]
    half, pad, P0, P1 = win // 2, win // 2 + 2, win + 3, win + 1
    s = lk_search_radius(win, Hp, Wp, search)
    WS = P1 + 2 * s
    runs = [_lk_level(*args, win, k, EPS, MIN_EIG, search=search) for k in range(iters + 1)]
    ok = runs[0][1]
    pos = torch.stack([gk for gk, _ in runs])          # [iters+1, n, 2]
    moved = (pos[1:] != pos[:-1]).any(-1).int()         # [iters, n]
    # iteration k+1 runs at pos[k]; it is needed while no earlier one froze
    need = torch.cat([torch.ones_like(moved[:1]), torch.cumprod(moved, 0)[:-1]]).bool()
    need &= ok[None]

    x0 = torch.clamp(floor_index(p0[:, 0]) - half - 1 + pad, 0, Wp - P0)[valid]
    y0 = torch.clamp(floor_index(p0[:, 1]) - half - 1 + pad, 0, Hp - P0)[valid]
    wx0 = torch.clamp(floor_index(g[:, 0]) - half - s + pad, 0, Wp - WS)
    wy0 = torch.clamp(floor_index(g[:, 1]) - half - s + pad, 0, Hp - WS)
    u = pos[:-1] - half
    lx = torch.clamp(floor_index(u[..., 0]) + pad - wx0, 0, WS - P1)
    ly = torch.clamp(floor_index(u[..., 1]) + pad - wy0, 0, WS - P1)
    px0 = union_pixels(Hp, Wp, y0, x0, P0)
    px1 = union_pixels(Hp, Wp, (wy0 + ly)[need], (wx0 + lx)[need], P1)
    nbytes = 4 * (px0 + px1) + n * (8 + 8 + 1) + n * (8 + 1)
    n_iter = int(need.sum())
    flops = int(valid.sum()) * ((win + 2) ** 2 * 7 + win * win * 10) + n_iter * win * win * 12
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), n_iter


def textured(h: int, w: int, gen, dev):
    """Smooth random texture in [0, 255] on the device."""
    import torch
    import torch.nn.functional as F

    coarse = 255.0 * torch.rand((h // 6 + 2, w // 6 + 2), generator=gen, device=dev)
    return F.interpolate(coarse[None, None], size=(h, w), mode="bilinear",
                         align_corners=False)[0, 0].contiguous()


def shifted(img, dx: float, dy: float):
    """img sampled at (x − dx, y − dy): the contents move by (dx, dy)."""
    import torch

    from vins_tpu_torch.frontend.image import bilinear

    h, w = img.shape
    yy, xx = torch.meshgrid(torch.arange(h, dtype=img.dtype, device=img.device),
                            torch.arange(w, dtype=img.dtype, device=img.device),
                            indexing="ij")
    return bilinear(img, torch.stack([xx - dx, yy - dy], -1)).contiguous()


def level_inputs(level: int, gen, dev):
    """Padded level images with a known sub-pixel shift, 150 features."""
    import torch

    from vins_tpu_torch.frontend.image import edge_pad

    h, w = LEVEL_SHAPES[level]
    pad = WIN // 2 + 2
    img0 = textured(h, w, gen, dev)
    img1 = shifted(img0, 0.7, -0.4)
    p0 = torch.rand((N_FEAT, 2), generator=gen, device=dev) \
        * torch.tensor([w - 3.0, h - 3.0], device=dev) + 1.0
    g = (p0 + 0.6 * (torch.rand((N_FEAT, 2), generator=gen, device=dev) - 0.5)).contiguous()
    valid = torch.rand((N_FEAT,), generator=gen, device=dev) > 0.1
    return (edge_pad(img0, pad).contiguous(), edge_pad(img1, pad).contiguous(),
            p0.contiguous(), g, valid)


def phase_kernel_vs_plain(dev, gen):
    """lk_level against klt._lk_level at the three level shapes, search 32
    and 10: ok identical, max |Δg| ≤ 1e-3 px over features ok in both (f32
    window sums in another order).  Returns the largest |Δg|."""
    import torch

    from vins_tpu_torch.frontend.klt import _lk_level
    from vins_tpu_torch.frontend.klt_cuda import lk_level

    worst = 0.0
    for level in range(3):
        args = level_inputs(level, gen, dev)
        for search in (32, 10):
            gk, okk = lk_level(*args, win=WIN, iters=ITERS, eps=EPS,
                               min_eig_thresh=MIN_EIG, search=search)
            gp, okp = _lk_level(*args, WIN, ITERS, EPS, MIN_EIG, search=search)
            torch.cuda.synchronize()
            check(bool(torch.equal(okk, okp)),
                  f"lk_level ok differs from the plain version (level {level}, search {search})")
            both = okk & okp
            err = float((gk - gp)[both].abs().max()) if bool(both.any()) else 0.0
            check(int(both.sum()) >= N_FEAT // 2, f"too few ok features at level {level}")
            check(err <= 1e-3, f"lk_level |Δg| {err} > 1e-3 px (level {level}, search {search})")
            worst = max(worst, err)
            log(f"phase 2: level {level} {tuple(args[0].shape)} search {search}: "
                f"ok {int(okk.sum())}/{N_FEAT} identical, max|Δg| {err:.3e} px")
    return worst


def phase_pyramid_shift(dev):
    """The 3-level pyramid on the kernel recovers a (5.3, −3.7) px shift at
    the four points of the JAX package's own test (320×240)."""
    import torch

    from vins_tpu_torch.frontend.klt import lk_pyramidal
    from vins_tpu_torch.frontend.klt_cuda import lk_level

    img0 = textured(240, 320, torch.Generator(device=dev).manual_seed(1), dev)
    img1 = shifted(img0, 5.3, -3.7)
    pts = torch.tensor([[60.0, 60.0], [160.0, 80.0], [240.0, 180.0], [100.0, 200.0]],
                       device=dev)
    before = lk_level.launches
    out, ok = lk_pyramidal(img0, img1, pts, torch.ones(len(pts), dtype=torch.bool, device=dev))
    torch.cuda.synchronize()
    check(lk_level.launches - before == 3, "lk_pyramidal did not launch the kernel per level")
    err = float((out - pts - torch.tensor([5.3, -3.7], device=dev)).abs().max())
    check(bool(ok.all()) and err < 0.05, f"pyramid shift error {err} px (ok {bool(ok.all())})")
    log(f"phase 2: 3-level pyramid recovers (5.3, -3.7) px to {err:.4f} px")


class plain_lk:
    """Within this block the LK wrapper runs its plain version on CUDA
    tensors too: the instance attribute shadows the kernel launch."""

    def __enter__(self):
        from vins_tpu_torch.frontend.klt import _lk_level
        from vins_tpu_torch.frontend.klt_cuda import lk_level

        lk_level.launch = _lk_level

    def __exit__(self, *exc):
        from vins_tpu_torch.frontend.klt_cuda import lk_level

        del lk_level.launch


def run_front(seq, dev, timed: bool = False, frames=None):
    """FeatureTracker.read_image over the sequence, publishing every second
    frame.  Track-only frames of the device frames run under CUDA sync-debug
    mode "error", so a host sync that it detects there fails the run.
    `frames` replaces the sequence's device frames with host ones; their
    upload is a blocking copy, so they run without that check.  Returns
    (published features by frame, per-frame event times)."""
    import torch

    from vins_tpu_torch.frontend.tracker import FeatureTracker
    from vins_tpu_torch.sim import proxy

    tr = FeatureTracker(proxy.euroc_camera(device=dev), max_cnt=N_FEAT, min_dist=30,
                        f_threshold=1.0, equalize=True, focal=proxy.FOCAL, device=dev)
    sync_check = frames is None
    published, times = {}, []
    for i, (t, img) in enumerate(zip(seq.t, seq.frames if frames is None else frames)):
        publish = i % 2 == 0
        if timed:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        if sync_check and not publish:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = tr.read_image(img, float(t), publish=publish)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if timed:
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        if out is not None:
            published[i] = out
    torch.cuda.synchronize()
    return published, times


def check_quality(q: dict, run: str) -> None:
    log(f"phase 3: {run}: published counts {q['counts']}")
    log(f"phase 3: {run} quality " + json.dumps(
        {k: v for k, v in q.items() if k not in ("frames", "counts")}))
    check(q["mean_count"] >= LIMITS["mean_count_min"],
          f"{run}: mean published count {q['mean_count']} < {LIMITS['mean_count_min']}")
    check(q["sampson_median_px"] <= LIMITS["sampson_median_max"],
          f"{run}: Sampson median {q['sampson_median_px']} px > {LIMITS['sampson_median_max']}")
    check(q["sampson_p90_px"] <= LIMITS["sampson_p90_max"],
          f"{run}: Sampson p90 {q['sampson_p90_px']} px > {LIMITS['sampson_p90_max']}")
    check(q["frac_over_1px"] <= LIMITS["frac_over_1px_max"],
          f"{run}: share over 1 px {q['frac_over_1px']} > {LIMITS['frac_over_1px_max']}")


def phase_lockstep(seq, dev):
    """Per frame, the front step with the plain LK from the kernel run's own
    state and RANSAC draw: published counts within ±3 % of the kernel's.
    (Two whole runs drift apart: a 1e-5 px LK difference can flip one RANSAC
    inlier, and the ids then diverge, so the per-frame comparison is made
    from a shared state.)  Returns the largest relative count difference."""
    import torch

    from vins_tpu_torch.frontend.fused import (make_front_state, make_front_step,
                                               unpack_front_blob)
    from vins_tpu_torch.frontend.tracker import N_HYP, gumbel_draw
    from vins_tpu_torch.sim import proxy

    step = make_front_step(proxy.euroc_camera(device=dev), N_FEAT, 30, 1.0, True,
                           proxy.FOCAL, device=dev)
    H, W = seq.frames[0].shape
    state = make_front_state(N_FEAT, H, W, device=dev)
    gen = torch.Generator(device=dev).manual_seed(42)
    n_id, worst = 0, 0.0
    for i, img in enumerate(seq.frames):
        publish, has_prev = i % 2 == 0, i > 0
        dt = float(np.float32(seq.t[i] - seq.t[i - 1])) if has_prev else 0.0
        gum = gumbel_draw((N_HYP, N_FEAT), gen, dev) if publish and has_prev else None
        new_state, blob_k = step(state, img, dt, gum, n_id, publish, has_prev)
        with plain_lk():
            _, blob_p = step(state, img, dt, gum, n_id, publish, has_prev)
        uk = unpack_front_blob(blob_k.cpu().numpy(), N_FEAT)
        up = unpack_front_blob(blob_p.cpu().numpy(), N_FEAT)
        a, b = int(uk[3].sum()), int(up[3].sum())
        check(abs(a - b) <= 0.03 * a, f"frame {i}: plain LK publishes {b}, kernel {a}")
        worst = max(worst, abs(a - b) / max(a, 1))
        n_id += uk[-1]
        state = new_state
    log(f"phase 3: lockstep: per-frame published counts, plain LK against the kernel "
        f"from the same state: largest difference {100 * worst:.2f} % over {len(seq.frames)} "
        f"frames")
    return worst


def phase_main(dev):
    import torch

    from vins_tpu_torch.frontend.klt_cuda import lk_level
    from vins_tpu_torch.sim import proxy

    t0 = time.perf_counter()
    seq = proxy.render_sequence(N_FRAMES, device=dev)
    torch.cuda.synchronize()
    log(f"phase 3: rendered {N_FRAMES} frames {tuple(seq.frames[0].shape)} "
        f"in {time.perf_counter() - t0:.2f} s")

    lk_level.launches = 0
    published, _ = run_front(seq, dev)
    launches = lk_level.launches
    tracked = N_FRAMES - 1
    check(launches == 3 * tracked,
          f"lk_level launched {launches} times, expected 3 x {tracked} tracked frames")
    log(f"phase 3: kernel run: lk_level launches {launches} (= 3 x {tracked} tracked "
        f"frames); sync-debug mode detected no host sync on a track-only frame")
    for k, f in published.items():
        check(np.isfinite(f.pts).all() and np.isfinite(f.vel).all() and f.pts.shape[1] == 2,
              f"frame {k}: non-finite or misshapen published features")
    q = proxy.track_quality(seq, published)
    check_quality(q, "kernel run")

    # the same sequence once more with the plain LK on the card
    with plain_lk():
        published_plain, _ = run_front(seq, dev)
    check(lk_level.launches == launches, "the plain run launched the kernel")
    qp = proxy.track_quality(seq, published_plain)
    check_quality(qp, "plain-LK run")
    check(qp["frames"] == q["frames"], "plain and kernel runs published different frames")
    drift = max(abs(a - b) / max(a, 1) for a, b in zip(q["counts"], qp["counts"]))
    log(f"phase 3: separate runs: largest per-frame count difference {100 * drift:.2f} %")
    phase_lockstep(seq, dev)
    return seq, launches


def phase_timing(dev, gen, seq):
    """Per level: the kernel and the plain version at the main path's shapes
    (device time); per frame: read_image on published and track-only
    frames (event time of the whole call, host gaps included), once with
    the frames already on the card and once with 8-bit host frames, as a
    camera delivers them, whose upload the call then includes."""
    from vins_tpu_torch.frontend.klt import _lk_level
    from vins_tpu_torch.frontend.klt_cuda import lk_level

    levels = []
    for level in (2, 1, 0):
        args = level_inputs(level, gen, dev)
        s = SEARCH[level]
        ms = device_ms(lambda: lk_level(*args, win=WIN, iters=ITERS, eps=EPS,
                                        min_eig_thresh=MIN_EIG, search=s),
                       sleep_cycles=2_000_000)
        plain = device_ms(lambda: _lk_level(*args, WIN, ITERS, EPS, MIN_EIG, search=s),
                          sleep_cycles=100_000_000)
        Hp, Wp = args[0].shape
        bound, by, n_iter = lk_bound_ms(args, s)
        levels.append(dict(level=level, shape=[Hp, Wp], search=s, ms=ms, plain_ms=plain,
                           bound_ms=bound, bound_by=by, iterations_needed=n_iter))
        log(f"phase 4: lk_level level {level} {Hp}x{Wp} search {s}: kernel {ms * 1e3:.1f} us, "
            f"plain {plain * 1e3:.1f} us, bound {bound * 1e3:.3f} us ({by}; "
            f"{n_iter} feature-iterations needed of {N_FEAT * ITERS})")
    host = [np.clip(np.rint(f.cpu().numpy()), 0, 255).astype(np.uint8) for f in seq.frames]
    frame = {}
    for kind, frames in (("device", None), ("host_u8", host)):
        _, times = run_front(seq, dev, timed=True, frames=frames)
        pub = [t for i, t in enumerate(times) if i >= 10 and i % 2 == 0]
        trk = [t for i, t in enumerate(times) if i >= 10 and i % 2 == 1]
        frame[kind] = dict(published_ms=float(np.median(pub)),
                           track_only_ms=float(np.median(trk)),
                           n_published=len(pub), n_track_only=len(trk))
        log(f"phase 4: read_image, {kind} frames, median over frames 10-59: published "
            f"{frame[kind]['published_ms']:.3f} ms (n={len(pub)}), track-only "
            f"{frame[kind]['track_only_ms']:.3f} ms (n={len(trk)})")
    return levels, frame


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vins_tpu_torch import build

    # ---- 0. device -------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not measured"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"phase 0: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off for matmul "
        f"and cuDNN; card: {card}")

    # ---- 1. build ----------------------------------------------------------
    for name in build.KERNELS:
        built = build.build(name)
        if built is None:
            log(f"phase 1: {name}: already built")
            continue
        sec, ptxas = built
        info = [ln.strip() for ln in ptxas.splitlines() if "registers" in ln or "smem" in ln]
        log(f"phase 1: {name}: built by nvcc in {sec:.2f} s; " + " | ".join(info))

    # ---- 2. kernels against their plain versions ---------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = phase_kernel_vs_plain(dev, gen)
    phase_pyramid_shift(dev)

    # ---- 3. the main path ----------------------------------------------------
    seq, launches = phase_main(dev)

    # ---- 4. timing -------------------------------------------------------------
    levels, frame = phase_timing(dev, gen, seq)
    log("phase 4: front-end " + json.dumps(frame))

    kernels = [dict(
        name="lk_level", route="cuda", source="vins_tpu_torch/csrc/lk_level.cu",
        replaces="vins_tpu/frontend/klt_pallas.py:166", launches=launches,
        max_abs_err=max_err,
        # one tracked frame: levels 2, 1, 0 at the main path's shapes
        ms=sum(lv["ms"] for lv in levels), plain_ms=sum(lv["plain_ms"] for lv in levels),
        bound_ms=sum(lv["bound_ms"] for lv in levels),
        bound_by=max(levels, key=lambda lv: lv["bound_ms"])["bound_by"],
        library_ms=None, per_level=levels)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
