"""Replay a EuRoC sequence through the full pipeline.

Counterpart of `tools/run_euroc.py`, the reference's `roslaunch
vins_estimator euroc.launch` with a rosbag played into it (README.md:66-89):
a producer thread feeds the measurement queue, a prefetch thread decodes
images ahead, and the main thread runs `Pipeline` in overlapped mode with
loop closure on (unless `--no-loop`) and the pose graph on its worker
thread, on `cuda` unless asked for the CPU.

    python -m vins_tpu_torch.run_euroc <dataset_root> [--config config/euroc.yaml]
        [--out DIR] [--no-loop] [--max-frames N] [--device cuda|cpu]

Writes DIR/vins_result_no_loop.tum and DIR/vins_result_loop.tum (the
reference's vins_result_no_loop.csv and vins_result_loop.csv,
vins_estimator/src/parameters.cpp:61, pose_graph_node.cpp:506, in TUM
format; the second only with loop closure on).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import queue
import threading
import time

import numpy as np

from .io.euroc import load_cam_index, load_imu
from .io.mq import MeasurementQueue
from .io.png import read_png_gray
from .pipeline import Pipeline

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "config", "euroc.yaml")


def load_image(path: str) -> np.ndarray:
    """A grayscale PGM (P5) or PNG as float32 [H,W]."""
    if path.endswith((".pgm", ".PGM")):
        with open(path, "rb") as f:
            if f.readline().strip() != b"P5":
                raise ValueError(f"{path}: not a binary PGM")
            line = f.readline()
            while line.startswith(b"#"):
                line = f.readline()
            w, h = map(int, line.split())
            f.readline()  # maxval
            img = np.frombuffer(f.read(w * h), np.uint8).reshape(h, w)
        return img.astype(np.float32)
    return read_png_gray(path).astype(np.float32)


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Put into a bounded queue unless `stop` is set first."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def replay(root: str, cfg, cam, loop: bool = True, max_frames: int = 0,
           progress_every: int = 100, pipe: Pipeline | None = None, device="cuda") -> Pipeline:
    """Replay a EuRoC-format directory: PNG decode (prefetch thread) →
    measurement queue (producer thread) → front-end → estimator → pose
    graph (with `loop`).  Returns the Pipeline, its trajectories filled, its
    pose-graph worker drained and stopped.  `pipe` replaces the Pipeline
    that is otherwise built from `cfg` and `cam` on `device`."""
    if pipe is None:
        pipe = Pipeline(cfg, cam, loop_closure=loop, device=device)
    imu = load_imu(root)
    cidx = load_cam_index(root)
    mq = MeasurementQueue()
    imgq: queue.Queue = queue.Queue(maxsize=8)
    stop = threading.Event()

    def produce():
        ki = 0
        for k in range(len(imu.t)):
            if stop.is_set():
                break
            mq.push_imu(imu.t[k], imu.acc[k], imu.gyr[k])
            while ki < len(cidx.t) and cidx.t[ki] + cfg.td <= imu.t[k]:
                mq.push_feature(cidx.t[ki], payload=ki)
                ki += 1
        mq.close()

    def prefetch():
        try:
            for path in cidx.paths:
                if not _put(imgq, load_image(path), stop):
                    return
        except Exception as e:  # noqa: BLE001 — handed to the consumer, which raises it
            _put(imgq, e, stop)

    threads = [threading.Thread(target=produce, name="imu_producer", daemon=True),
               threading.Thread(target=prefetch, name="image_prefetch", daemon=True)]
    for th in threads:
        th.start()
    n = img_i = 0
    t0 = time.perf_counter()
    try:
        while True:
            m = mq.next(td=cfg.td)
            if m is None:
                break
            for k in range(len(m.imu_t)):
                pipe.process_imu(m.imu_t[k], m.imu_acc[k], m.imu_gyr[k])
            # the prefetch stream is index-aligned with the camera frames:
            # skip the images of frames the aligner dropped
            while img_i < m.payload:
                skipped = imgq.get()
                if isinstance(skipped, Exception):
                    raise RuntimeError("image prefetch failed") from skipped
                img_i += 1
            img = imgq.get()
            img_i += 1
            if isinstance(img, Exception):
                raise RuntimeError("image prefetch failed") from img
            out = pipe.process_image(img, m.t_img)
            n += 1
            if progress_every and n % progress_every == 0:
                fps = n / (time.perf_counter() - t0)
                print(f"frame {n}  {fps:.1f} fps  {out.get('kind', '')}", flush=True)
            if max_frames and n >= max_frames:
                break
    finally:
        stop.set()
        mq.close()
        for th in threads:
            th.join(timeout=60)
    pipe.pg_join()
    pipe.shutdown()
    return pipe


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    ap.add_argument("--out", default=".")
    ap.add_argument("--no-loop", action="store_true", help="loop closure off")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> Pipeline:
    from .config import load_config
    from .core.cameras import camera_from_yaml

    args = parse_args(argv)
    # the pose graph runs on its worker thread, off the frame loop (the
    # reference's separate pose_graph process)
    cfg = dataclasses.replace(load_config(args.config), pg_async=True, overlap=True)
    cam = camera_from_yaml(cfg.camera, device=args.device)
    pipe = replay(args.root, cfg, cam, loop=not args.no_loop, max_frames=args.max_frames,
                  device=args.device)
    os.makedirs(args.out, exist_ok=True)
    pipe.write_trajectories(os.path.join(args.out, "vins_result_no_loop.tum"),
                            os.path.join(args.out, "vins_result_loop.tum"))
    print(f"done: {len(pipe.trajectory)} poses")
    return pipe


if __name__ == "__main__":
    main()
