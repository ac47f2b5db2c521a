"""Port parity: vins_tpu_torch.sim.driver against vins_tpu.sim.driver on the
CPU.

The port driver is made from the JAX one (`convert.synthetic_driver`: the
same landmarks, rates, biases and extrinsic), and both drive a stub
estimator that records every call and stays INITIAL, for 40 frames of the
figure-8 at 10 Hz with the IMU at 200 Hz.  Both are float64 from the same
closed forms, so the call streams agree to 1e-12 (reduction order only)
and the published ids are identical.  `ate_rmse` gets the same `SimRun`
arrays in both packages."""
import numpy as np
import pytest
import torch

from vins_tpu.sim import driver as jdriver
from vins_tpu_torch import convert
from vins_tpu_torch.sim import driver as tdriver

torch.set_num_threads(1)
N_FRAMES = 40
TOL = 1e-12


class Recorder:
    """A stub estimator: records the calls, stays INITIAL."""

    solver_flag = 0

    def __init__(self):
        self.imu, self.img = [], []

    def process_imu(self, dt, acc, gyr):
        self.imu.append((dt, np.array(acc), np.array(gyr)))

    def process_image(self, ids, pts, vels, uvs, t):
        self.img.append((np.array(ids), np.array(pts), np.array(vels), np.array(uvs), t))
        return {"kind": "recorded"}


def drive(driver, **kw):
    rec = Recorder()
    return rec, driver.run(rec, n_frames=N_FRAMES, **kw)


@pytest.fixture(scope="module")
def runs():
    jd = jdriver.SyntheticDriver(imu_hz=200.0, frame_hz=10.0, g_norm=9.81)
    td = convert.synthetic_driver(jd)
    jrec, jrun = drive(jd)
    trec, trun = drive(td)
    return dict(jd=jd, td=td, jrec=jrec, jrun=jrun, trec=trec, trun=trun)


def test_imu_stream_matches_jax(runs):
    j, t = runs["jrec"].imu, runs["trec"].imu
    assert len(t) == len(j) == (N_FRAMES - 1) * 20
    np.testing.assert_array_equal([d for d, _, _ in t], [d for d, _, _ in j])
    for k in (1, 2):
        np.testing.assert_allclose(np.stack([c[k] for c in t]), np.stack([c[k] for c in j]),
                                   rtol=0, atol=TOL)


def test_image_stream_matches_jax(runs):
    j, t = runs["jrec"].img, runs["trec"].img
    assert len(t) == len(j) == N_FRAMES
    for (ji, jp, jv, ju, jt), (ti, tp, tv, tu, tt) in zip(j, t):
        np.testing.assert_array_equal(ti, ji)
        assert 50 <= len(ti) <= 150
        for a, b in ((tp, jp), (tv, jv), (tu, ju)):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
        assert abs(tt - jt) <= TOL


def test_ground_truth_matches_jax(runs):
    jrun, trun = runs["jrun"], runs["trun"]
    np.testing.assert_allclose(trun.t, jrun.t, rtol=0, atol=TOL)
    np.testing.assert_allclose(trun.p_gt, jrun.p_gt, rtol=0, atol=TOL)
    np.testing.assert_allclose(trun.q_gt, jrun.q_gt, rtol=0, atol=TOL)
    # no estimate before NON_LINEAR
    assert np.isnan(trun.p_est).all() and np.isnan(trun.q_est).all()
    assert [e["kind"] for e in trun.events] == ["recorded"] * N_FRAMES


def test_own_landmarks_from_the_generator():
    """Without a JAX driver the landmarks are the port's own draw: the box of
    the JAX driver (centre (0, 0, 0.8), half-widths (12, 12, 5)), the same
    points for the same generator seed."""
    a = tdriver.SyntheticDriver().points
    b = tdriver.SyntheticDriver(key=torch.Generator().manual_seed(0)).points
    c = tdriver.SyntheticDriver(key=torch.Generator().manual_seed(1)).points
    assert a.shape == (600, 3) and a.dtype == torch.float64
    assert torch.equal(a, b) and not torch.equal(a, c)
    lo, hi = torch.tensor([-12.0, -12.0, -4.2]), torch.tensor([12.0, 12.0, 5.8])
    assert bool(((a >= lo) & (a <= hi)).all())


def test_stored_points_are_the_jax_drivers(runs):
    """`jax_driver_points` (the stored file) is the JAX driver's default
    draw, bit for bit."""
    got = tdriver.jax_driver_points()
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(runs["jd"].points))


def test_pixel_noise_from_the_generator(runs):
    """Pixel noise is σ times the generator's normal draws over every
    landmark, one [600, 2] draw a frame, added before the ids are cut; the
    ids do not move."""
    sigma = 1.5 / 460.0
    rec, _ = drive(runs["td"], pix_noise=sigma, noise_key=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    for (ti, tp, _, tu, _), (ci, cp, _, _, _) in zip(rec.img, runs["trec"].img):
        draw = torch.randn((600, 2), generator=gen, dtype=torch.float64).numpy()
        np.testing.assert_array_equal(ti, ci)
        np.testing.assert_allclose(tp, cp + sigma * draw[ti], rtol=0, atol=TOL)
        np.testing.assert_allclose(tu, tp * 460.0, rtol=0, atol=0)


def sim_run(mod, runs, p_est):
    jrun = runs["jrun"]
    q = np.full((N_FRAMES, 4), np.nan)
    return mod.SimRun(t=jrun.t, p_gt=jrun.p_gt, q_gt=jrun.q_gt, p_est=p_est, q_est=q, events=[])


@pytest.mark.parametrize("case", ["yaw_aligned", "unaligned", "one_estimate"])
def test_ate_rmse_matches_jax(runs, case):
    """A yawed, shifted, noisy estimate with NaNs before 'initialization'."""
    rng = np.random.default_rng(3)
    c, s = np.cos(0.4), np.sin(0.4)
    Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    p_est = runs["jrun"].p_gt @ Rz.T + np.array([0.3, -0.2, 0.1])
    p_est = p_est + 0.02 * rng.standard_normal(p_est.shape)
    p_est[: N_FRAMES - 1 if case == "one_estimate" else 12] = np.nan
    yaw = case != "unaligned"
    got = tdriver.ate_rmse(sim_run(tdriver, runs, p_est), yaw_align=yaw)
    want = jdriver.ate_rmse(sim_run(jdriver, runs, p_est), yaw_align=yaw)
    if case == "one_estimate":
        assert got == want == float("inf")
    else:
        assert np.isfinite(want) and abs(got - want) <= TOL
        assert (want < 0.05) == yaw  # alignment removes the yaw and the shift



if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    np.save(tdriver.JAX_POINTS_FILE, np.asarray(jdriver.SyntheticDriver().points))
    print(f"wrote {tdriver.JAX_POINTS_FILE}")
