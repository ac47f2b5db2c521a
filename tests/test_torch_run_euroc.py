"""`run_euroc.replay` raises in the calling thread when an image fails to
decode, whether or not the aligner keeps that frame.

A 3-frame EuRoC tree whose broken frame comes first, at t = 0.5 s, before
the first IMU sample (t = 1.0 s): the aligner drops it, so the replay
skips its image, and that skip must raise too instead of waiting for an
image the prefetch thread will never send.  The same broken frame at
t = 1.05 s, which the aligner keeps, is the case the replay always raised
on.  Needs no JAX: a stub stands in for the pipeline."""
import os
import threading

import numpy as np
import pytest

from vins_tpu_torch.config import VinsConfig
from vins_tpu_torch.io.png import write_png_gray
from vins_tpu_torch.run_euroc import replay


class Stub:
    def __init__(self):
        self.images = []

    def process_imu(self, t, acc, gyr):
        pass

    def process_image(self, img, t, gumbel=None):
        self.images.append(t)
        return {}

    def pg_join(self):
        pass

    def shutdown(self):
        pass


def write_tree(root, stamps, broken):
    cam = os.path.join(root, "mav0", "cam0")
    os.makedirs(os.path.join(cam, "data"))
    os.makedirs(os.path.join(root, "mav0", "imu0"))
    img = np.random.default_rng(0).integers(0, 255, (48, 64)).astype(np.uint8)
    with open(os.path.join(cam, "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for k, t in enumerate(stamps):
            name = f"{int(round(t * 1e9))}.png"
            f.write(f"{int(round(t * 1e9))},{name}\n")
            path = os.path.join(cam, "data", name)
            if k == broken:
                with open(path, "wb") as g:
                    g.write(b"not a png")
            else:
                write_png_gray(path, img)
    with open(os.path.join(root, "mav0", "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for t in np.arange(1.0, 1.2 + 1e-9, 0.005):
            f.write(f"{int(round(t * 1e9))},0,0,0,0,0,9.81\n")


@pytest.mark.parametrize("stamps", [(0.5, 1.05, 1.10), (1.05, 1.10, 1.15)],
                         ids=["dropped_frame", "kept_frame"])
def test_replay_raises_on_a_broken_image(tmp_path, stamps):
    write_tree(str(tmp_path), stamps, broken=0)
    result = {}

    def run():
        try:
            replay(str(tmp_path), VinsConfig(), None, pipe=Stub(), progress_every=0)
        except Exception as e:  # noqa: BLE001 — handed to the test thread
            result["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=20)
    assert not th.is_alive(), "replay blocked on a broken image"
    err = result.get("error")
    assert isinstance(err, RuntimeError) and str(err) == "image prefetch failed"
    assert isinstance(err.__cause__, Exception)
