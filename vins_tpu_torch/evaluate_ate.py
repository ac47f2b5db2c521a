"""ATE RMSE scoring of a TUM-format trajectory against EuRoC ground truth.

Counterpart of `tools/evaluate_ate.py` (the quantitative evaluation the
reference never shipped: its benchmark_publisher only draws an aligned path,
benchmark_publisher_node.cpp:74-).  Alignment is 4-DoF (yaw + translation)
by default, the gauge freedom of a VIO system, or SE(3) Umeyama with
--se3.  Host numpy only.

    python -m vins_tpu_torch.evaluate_ate traj.tum groundtruth.csv [--se3] [--max-dt 0.02]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .io.euroc import load_groundtruth


def load_tum(path):
    d = np.loadtxt(path)
    return d[:, 0], d[:, 1:4], d[:, 4:8]  # t, p, q(xyzw)


def associate(t_a, t_b, max_dt=0.02):
    j = np.searchsorted(t_b, t_a)
    j = np.clip(j, 1, len(t_b) - 1)
    prev_closer = np.abs(t_b[j - 1] - t_a) < np.abs(t_b[j] - t_a)
    j = j - prev_closer
    ok = np.abs(t_b[j] - t_a) <= max_dt
    return j, ok


def align_yaw_t(P, G):
    Pc = P - P.mean(0)
    Gc = G - G.mean(0)
    num = np.sum(Gc[:, 1] * Pc[:, 0] - Gc[:, 0] * Pc[:, 1])
    den = np.sum(Gc[:, 0] * Pc[:, 0] + Gc[:, 1] * Pc[:, 1])
    th = np.arctan2(num, den)
    c, s = np.cos(th), np.sin(th)
    Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    return (Rz @ Pc.T).T + G.mean(0)


def align_se3(P, G):
    Pc = P - P.mean(0)
    Gc = G - G.mean(0)
    U, S, Vt = np.linalg.svd(Gc.T @ Pc)
    D = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    return (R @ Pc.T).T + G.mean(0)


def main(argv=None) -> None:
    """Score and print (exit 1 on fewer than 10 associated poses)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("traj")
    ap.add_argument("groundtruth")
    ap.add_argument("--se3", action="store_true")
    ap.add_argument("--max-dt", type=float, default=0.02)
    args = ap.parse_args(argv)

    t, p, _ = load_tum(args.traj)
    gt = load_groundtruth(args.groundtruth)
    j, ok = associate(t, gt.t, args.max_dt)
    P, G = p[ok], gt.p[j[ok]]
    if len(P) < 10:
        print("too few associations")
        sys.exit(1)
    A = align_se3(P, G) if args.se3 else align_yaw_t(P, G)
    e = np.linalg.norm(A - G, axis=1)
    print(f"matched {len(P)} poses")
    print(f"ATE RMSE  {np.sqrt((e ** 2).mean()):.4f} m")
    print(f"ATE mean  {e.mean():.4f} m   median {np.median(e):.4f} m   max {e.max():.4f} m")


if __name__ == "__main__":
    main()
