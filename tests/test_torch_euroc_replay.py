"""The port's EuRoC replay chain on the CPU: PNG on disk → decode (prefetch
thread) → measurement queue (producer thread) → Pipeline, on the 3 s tree
the port's writer makes with the arguments of tests/test_euroc_replay.py
(duration 3.0, period 16, seed 0).

Of that test's three asserts (tests/test_euroc_replay.py:42-55) this file
holds the two that do not depend on when the estimator initializes: the
chain consumes the frames (here: every one of them reaches the pipeline, in
order), and no failure.  On this tree neither package initializes within
the 3 s (the JAX pipeline, replaying it with tools/run_euroc.replay: 0
poses; the port: 0 poses, with its own or with JAX's RANSAC draws), so the
pose count and the ATE are held on the card instead, where `chip_smoke.py`
phase 6 replays the 10 s tree."""
import numpy as np
import pytest
import torch

from vins_tpu_torch.config import VinsConfig
from vins_tpu_torch.io.euroc import load_cam_index, load_imu
from vins_tpu_torch.run_euroc import load_image, replay
from vins_tpu_torch.sim import proxy
from vins_tpu_torch.sim.euroc_writer import write_euroc_dataset


def make_cfg():
    """tests/test_euroc_replay.py's configuration, overlapped."""
    return VinsConfig(image_width=proxy.EUROC_W, image_height=proxy.EUROC_H, focal=460.0,
                      max_cnt=150, min_dist=30, freq=10, max_landmarks=256, g_norm=9.81,
                      extrinsic_R=proxy.R_IC_FORWARD, extrinsic_t=tuple(proxy.TIC), acc_n=0.08,
                      gyr_n=0.004, loop_closure=False, overlap=True)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("euroc_synth"))
    threads = torch.get_num_threads()
    torch.set_num_threads(8)  # the renderer's 752×480 frames
    try:
        info = write_euroc_dataset(root, duration=3.0, period=16.0, seed=0, device="cpu")
    finally:
        torch.set_num_threads(threads)
    return info


class Recorder:
    """A stand-in pipeline that records what the replay feeds it."""

    def __init__(self):
        self.imu, self.images, self.ended = [], [], 0

    def process_imu(self, t, acc, gyr):
        self.imu.append((t, np.array(acc), np.array(gyr)))

    def process_image(self, img, t, gumbel=None):
        self.images.append((t, img))
        return {}

    def pg_join(self):
        self.ended += 1

    def shutdown(self):
        self.ended += 1


def test_replay_feeds_the_aligned_stream(tree):
    """The threads deliver exactly the offline alignment
    (`iter_measurements`) and each frame's own decoded image."""
    from vins_tpu_torch.io.euroc import iter_measurements

    rec = replay(tree["root"], make_cfg(), None, pipe=Recorder(), progress_every=0)
    imu, cam = load_imu(tree["root"]), load_cam_index(tree["root"])
    ref = list(iter_measurements(imu, cam))
    assert [t for t, _ in rec.images] == [m.t_img for m in ref]
    assert len(ref) == tree["n_frames"]
    rows = [(t, a, g) for m in ref for t, a, g in zip(m.imu_t, m.imu_acc, m.imu_gyr)]
    assert len(rec.imu) == len(rows)
    for (t1, a1, g1), (t2, a2, g2) in zip(rec.imu, rows):
        assert t1 == t2
        np.testing.assert_allclose(a1, a2, rtol=0, atol=1e-12)
        np.testing.assert_allclose(g1, g2, rtol=0, atol=1e-12)
    for (_, img), m in zip(rec.images, ref):
        np.testing.assert_array_equal(img, load_image(m.image_path))
    assert rec.ended == 2


@pytest.fixture(scope="module")
def replayed(tree):
    threads = torch.get_num_threads()
    torch.set_num_threads(4)  # the pipeline's image ops
    try:
        cfg = make_cfg()
        pipe = proxy.make_pipeline(device="cpu", overlap=True, loop_closure=False)
        seen = []
        process = pipe.process_image

        def counted(img, t, gumbel=None):
            seen.append(t)
            return process(img, t, gumbel)

        pipe.process_image = counted
        replay(tree["root"], cfg, None, pipe=pipe, progress_every=0, device="cpu")
    finally:
        torch.set_num_threads(threads)
    return pipe, seen


def test_replay_consumes_all_frames(tree, replayed):
    pipe, seen = replayed
    assert seen == sorted(seen) and len(seen) == tree["n_frames"]
    assert pipe._pending is None and pipe._est_pending is None  # flushed at the end


def test_replay_runs_without_failure(replayed):
    pipe, _ = replayed
    assert pipe.estimator.failures == 0
    assert pipe.estimator.imu_overflow == 0
