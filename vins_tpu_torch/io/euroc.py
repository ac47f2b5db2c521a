"""EuRoC MAV dataset (ASL folder layout) loader.

A copy of `vins_tpu/io/euroc.py` for the port.  It replaces the reference's
rosbag replay path (README.md:66-89: EuRoC bags played into the three
nodes).  Reads the raw ASL tree:

    <root>/mav0/imu0/data.csv           t[ns], wx, wy, wz, ax, ay, az
    <root>/mav0/cam0/data.csv           t[ns], filename
    <root>/mav0/cam0/data/<stamp>.png   752×480 grayscale
    <root>/mav0/state_groundtruth_estimate0/data.csv   (or the
        benchmark_publisher copies: t[ns], p, q, v, bw, ba)

Image decoding is lazy (returns file paths; the front-end loads pixels), so
the loader works even without images present (IMU/GT-only workflows).
"""
from __future__ import annotations

import os
from typing import Iterator, NamedTuple

import numpy as np


class ImuData(NamedTuple):
    t: np.ndarray  # [N] seconds
    gyr: np.ndarray  # [N,3]
    acc: np.ndarray  # [N,3]


class CamIndex(NamedTuple):
    t: np.ndarray  # [M] seconds
    paths: list  # [M] absolute image paths


class GroundTruth(NamedTuple):
    t: np.ndarray  # [K] seconds
    p: np.ndarray  # [K,3]
    q: np.ndarray  # [K,4] wxyz


def _read_csv(path: str) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(x) for x in line.replace(",", " ").split()[: 17]])
    return np.asarray(rows)


def load_imu(root: str) -> ImuData:
    d = _read_csv(os.path.join(root, "mav0", "imu0", "data.csv"))
    return ImuData(t=d[:, 0] * 1e-9, gyr=d[:, 1:4], acc=d[:, 4:7])


def load_cam_index(root: str, cam: str = "cam0") -> CamIndex:
    base = os.path.join(root, "mav0", cam)
    ts, paths = [], []
    with open(os.path.join(base, "data.csv")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            stamp, name = line.split(",")[:2]
            ts.append(float(stamp) * 1e-9)
            paths.append(os.path.join(base, "data", name.strip()))
    return CamIndex(t=np.asarray(ts), paths=paths)


def load_groundtruth(path_or_root: str) -> GroundTruth:
    """Accepts a benchmark_publisher-style data.csv
    (benchmark_publisher/config/<seq>/data.csv: t[ns] p q v ...) or a dataset
    root containing mav0/state_groundtruth_estimate0/data.csv."""
    if os.path.isdir(path_or_root):
        path = os.path.join(
            path_or_root, "mav0", "state_groundtruth_estimate0", "data.csv"
        )
    else:
        path = path_or_root
    d = _read_csv(path)
    return GroundTruth(t=d[:, 0] * 1e-9, p=d[:, 1:4], q=d[:, 4:8])


class Measurement(NamedTuple):
    """One aligned packet: the image frame plus its IMU interval
    (estimator_node.cpp:98-136 getMeasurements: IMUs in (t_prev, t_img+td]
    with one boundary sample kept)."""

    t_img: float
    image_path: str
    imu_t: np.ndarray
    imu_acc: np.ndarray
    imu_gyr: np.ndarray


def iter_measurements(
    imu: ImuData, cam: CamIndex, td: float = 0.0, start: float | None = None,
) -> Iterator[Measurement]:
    """Time-align camera frames with IMU intervals.  The straddling sample is
    split by linear interpolation so every interval ends exactly at
    t_img + td (estimator_node.cpp:246-264); the interpolated row doubles as
    the next interval's opening boundary."""
    i = 0
    n = len(imu.t)
    first = True
    bound: tuple | None = None  # interp boundary row carried between frames
    for k in range(len(cam.t)):
        t_end = cam.t[k] + td
        if start is not None and cam.t[k] < start:
            continue
        j = i
        while j < n and imu.t[j] <= t_end:
            j += 1
        if j >= n:
            return
        if first:
            # skip frames before the first IMU sample
            if imu.t[i] > t_end:
                continue
            first = False
        ts = list(imu.t[i:j])
        accs = list(imu.acc[i:j])
        gyrs = list(imu.gyr[i:j])
        if bound is not None:
            ts.insert(0, bound[0]); accs.insert(0, bound[1]); gyrs.insert(0, bound[2])
        if not ts or ts[-1] < t_end:
            # split the straddling sample at exactly t_end
            if ts:
                t0, a0, g0 = ts[-1], accs[-1], gyrs[-1]
            else:  # interval fully inside one IMU step: interp from boundary
                t0, a0, g0 = bound
            w = (t_end - t0) / (imu.t[j] - t0)
            ai = a0 + w * (imu.acc[j] - a0)
            gi = g0 + w * (imu.gyr[j] - g0)
            ts.append(t_end); accs.append(ai); gyrs.append(gi)
            bound = (t_end, ai, gi)
            i = j
        else:
            bound = None
            i = j - 1  # keep one boundary sample for the next interval
        yield Measurement(
            t_img=float(cam.t[k]),
            image_path=cam.paths[k],
            imu_t=np.asarray(ts, float),
            imu_acc=np.stack(accs).astype(float),
            imu_gyr=np.stack(gyrs).astype(float),
        )


def write_tum(path: str, t: np.ndarray, p: np.ndarray, q_wxyz: np.ndarray):
    """TUM trajectory format (t x y z qx qy qz qw) — the standard input for
    ATE tools; the reference writes a CSV variant (visualization.cpp:157-171)."""
    with open(path, "w") as f:
        for k in range(len(t)):
            w, x, y, z = q_wxyz[k]
            f.write(
                f"{t[k]:.9f} {p[k,0]:.6f} {p[k,1]:.6f} {p[k,2]:.6f} "
                f"{x:.6f} {y:.6f} {z:.6f} {w:.6f}\n"
            )
