"""The port's overlapped frame path ≡ its serial path, on the CPU.

Port of tests/test_overlap.py.  `Pipeline(overlap=True)` runs the estimator
one published frame behind the front-end (pipeline.py
`_process_image_overlapped`); the estimator sees the same inputs in the same
order, so the trajectory equals the serial one (float64 on the CPU: to
1e-9).  The frames are the proxy's (752×480, the 200 Hz noisy biased IMU),
2 s from t = 5 s, where the estimator initializes at its first attempt (the
tenth published frame).  The JAX test's 3 s from t = 1 s would take ~35 s
here: five failed initialization attempts of ~1.3 s each come first, and
each frame takes ~0.4 s to render."""
import numpy as np
import pytest
import torch

from vins_tpu_torch.estimator.estimator import INITIAL
from vins_tpu_torch.sim import proxy

SECONDS, T0 = 2.0, 5.0


def drive(pipe, inp) -> list:
    """The proxy's IMU and frames through `pipe` (as `run_proxy` feeds them);
    the events of every call: an overlapped call returns earlier frames'
    events, also on a frame it does not publish."""
    events = []
    for fi, t in enumerate(inp.t):
        if fi > 0:
            for ti, a, w in zip(inp.imu_t[fi - 1], inp.acc[fi - 1], inp.gyr[fi - 1]):
                pipe.process_imu(float(ti), a, w)
        events.append(pipe.process_image(inp.frames[fi], float(t)))
    return events


@pytest.fixture(scope="module")
def runs():
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(8)  # the renderer's 752×480 frames
        inp = proxy.proxy_inputs(duration=SECONDS, t0=T0, device="cpu")
        torch.set_num_threads(4)  # the pipelines' image ops
        spipe = proxy.make_pipeline(device="cpu", loop_closure=False)
        serial = drive(spipe, inp)
        pipe = proxy.make_pipeline(device="cpu", overlap=True, loop_closure=False)
        over = drive(pipe, inp)
        flushed = pipe.flush_frames()
    finally:
        torch.set_num_threads(threads)
    return dict(serial=serial, over=over, flushed=flushed, spipe=spipe, pipe=pipe,
                traj_serial=list(spipe.trajectory), traj_over=list(pipe.trajectory))


def test_overlap_trajectory_matches_serial(runs):
    ta, tb = runs["traj_serial"], runs["traj_over"]
    # the overlapped pipeline holds the last published frame until the flush
    assert len(tb) == len(ta) > 5
    for (t1, p1, q1), (t2, p2, q2) in zip(ta, tb):
        assert t1 == t2
        np.testing.assert_allclose(p1, p2, atol=1e-9)
        np.testing.assert_allclose(q1, q2, atol=1e-9)


def test_overlap_events_match_serial(runs):
    """The same events, each reported one or two published frames late."""
    kinds = lambda evs: [e["kind"] for e in evs if e.get("kind")]  # noqa: E731
    serial = kinds(runs["serial"])
    assert "initialized" in serial and serial[-1] == "vio"
    assert kinds(runs["over"]) + kinds(runs["flushed"]) == serial
    assert runs["pipe"].estimator.failures == runs["spipe"].estimator.failures == 0


def test_overlap_restart_recovers(runs):
    """A stream gap restarts cleanly in overlapped mode: the pending frame
    and step are dropped, the IMU backlog cleared, a new sequence opened,
    and the estimator rebooted with an empty prior."""
    pipe = runs["pipe"]
    seq0 = pipe.sequence
    pipe.process_imu(pipe._last_image_time + 0.005, np.zeros(3), np.zeros(3))
    img = np.zeros((pipe.cfg.image_height, pipe.cfg.image_width), np.float32)
    t_gap = pipe._last_image_time + 5.0
    pipe.process_image(img, t_gap)
    assert pipe.sequence == seq0 + 1
    assert pipe._pending is None or pipe._pending[0] == t_gap
    assert pipe._est_pending is None and pipe._imu_backlog == []
    est = pipe.estimator
    assert est.solver_flag == INITIAL and not bool(est.prior.valid)
