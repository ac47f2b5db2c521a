"""Offline intrinsic calibration from chessboard images.

Counterpart of `tools/calibrate_camera.py` (the reference's `Calibration`
executable, camera_model/src/intrinsic_calib.cc): read the PNGs of a
directory, find the board in each, calibrate the chosen model and write a
camera yaml in the reference's format, readable by `config.py`.  Corner
detection and calibration run on `--device` (float64 calibration).

    python -m vins_tpu_torch.calibrate_camera -i DIR [-w 8] [--rows 5] [-s 0.03]
        [--model PINHOLE|KANNALA_BRANDT] [--camera-name camera] [-o out.yaml]
        [--iters 25] [--device cuda|cpu]

Prints one line per image to standard error, then as the last line of
standard output the JAX tool's JSON ({"views_used", "rms_px", "output"}).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np
import torch

from .calib.chessboard import board_object_points, find_chessboard
from .calib.intrinsics import calibrate
from .io.png import read_png_gray


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-i", "--input", required=True, help="directory of PNG images")
    ap.add_argument("-p", "--prefix", default="", help="image filename prefix filter")
    ap.add_argument("-w", "--cols", type=int, default=8, help="inner corners per row")
    ap.add_argument("--rows", type=int, default=5, help="inner corners per column")
    ap.add_argument("-s", "--square", type=float, default=0.03, help="square size [m]")
    ap.add_argument("--model", default="PINHOLE", choices=["PINHOLE", "KANNALA_BRANDT"])
    ap.add_argument("--camera-name", default="camera")
    ap.add_argument("-o", "--output", default="camera_calib.yaml")
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def camera_yaml(model: str, name: str, hw, intr: np.ndarray) -> str:
    """The camera yaml of the reference's format for `intr`."""
    if model == "PINHOLE":
        body = (
            f"model_type: PINHOLE\ncamera_name: {name}\n"
            f"image_width: {hw[1]}\nimage_height: {hw[0]}\n"
            "distortion_parameters:\n"
            f"   k1: {intr[4]:.10e}\n   k2: {intr[5]:.10e}\n"
            f"   p1: {intr[6]:.10e}\n   p2: {intr[7]:.10e}\n"
            "projection_parameters:\n"
            f"   fx: {intr[0]:.10e}\n   fy: {intr[1]:.10e}\n"
            f"   cx: {intr[2]:.10e}\n   cy: {intr[3]:.10e}\n"
        )
    else:
        body = (
            f"model_type: KANNALA_BRANDT\ncamera_name: {name}\n"
            f"image_width: {hw[1]}\nimage_height: {hw[0]}\n"
            "projection_parameters:\n"
            f"   k2: {intr[4]:.10e}\n   k3: {intr[5]:.10e}\n"
            f"   k4: {intr[6]:.10e}\n   k5: {intr[7]:.10e}\n"
            f"   mu: {intr[0]:.10e}\n   mv: {intr[1]:.10e}\n"
            f"   u0: {intr[2]:.10e}\n   v0: {intr[3]:.10e}\n"
        )
    return "%YAML:1.0\n---\n" + body


def main(argv=None) -> tuple:
    """Detect, calibrate, write the yaml; returns the JSON's dict, the
    `CalibResult` and the corners of the views used [V, rows·cols, 2]."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("calibrate_camera: no CUDA device is visible (use --device cpu)")
    paths = sorted(glob.glob(os.path.join(args.input, args.prefix + "*.png")))
    if not paths:
        sys.exit(f"no {args.prefix}*.png under {args.input}")

    obj = board_object_points(args.rows, args.cols, args.square)
    imgs, hw = [], None
    for p in paths:
        img = read_png_gray(p)
        hw = img.shape
        corners, ok = find_chessboard(img.astype(np.float32), args.rows, args.cols,
                                      device=args.device)
        if ok:
            imgs.append(corners)
        print(f"  {os.path.basename(p)}: {'ok' if ok else 'no board'}", file=sys.stderr)
    if len(imgs) < 3:
        sys.exit(f"only {len(imgs)} usable views; need >= 3")

    dev = torch.device(args.device)
    res = calibrate(torch.from_numpy(np.stack([obj] * len(imgs))).to(dev),
                    torch.from_numpy(np.stack(imgs)).to(dev),
                    torch.ones((len(imgs), len(obj)), dtype=torch.bool, device=dev),
                    model=args.model, iters=args.iters)
    intr = res.intrinsics.cpu().numpy().astype(float)
    with open(args.output, "w") as f:
        f.write(camera_yaml(args.model, args.camera_name, hw, intr))
    out = {"views_used": len(imgs), "rms_px": round(float(res.rms), 4), "output": args.output}
    print(json.dumps(out), flush=True)
    return out, res, np.stack(imgs)


if __name__ == "__main__":
    main()
