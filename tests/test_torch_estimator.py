"""Port parity: vins_tpu_torch.estimator.Estimator against vins_tpu's on the
CPU.

A SyntheticDriver run (the exact figure-8 scene of tests/test_estimator_e2e.py,
24 frames at 10 Hz, IMU at 200 Hz) drives the JAX Estimator; its IMU and
feature calls are recorded as numpy and replayed into the port's Estimator,
whose initializer gets the JAX initializer's RANSAC draws.  Both run in
float64, so the trajectories agree to 1e-6 m (measured ~1e-9 m: reduction
order only).  A third Estimator is made from the JAX one's whole state at
frame 18 (`convert.estimator_state`) and continues from there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vins_tpu.config import VinsConfig as JConfig
from vins_tpu.estimator.estimator import Estimator as JEstimator
from vins_tpu.sim.driver import SimRun, SyntheticDriver, ate_rmse
from vins_tpu.sim.window import R_IC_FORWARD
from vins_tpu_torch import convert
from vins_tpu_torch.estimator.estimator import NON_LINEAR
from vins_tpu_torch.estimator.estimator import Estimator as TEstimator

torch.set_num_threads(1)
N_FRAMES, HANDOFF = 24, 18
TRAJ_TOL = 1e-6  # m, float64 on both sides


def make_cfg():
    return JConfig(max_landmarks=160, g_norm=9.81, extrinsic_R=R_IC_FORWARD,
                   extrinsic_t=(0.06, -0.01, 0.02))


def jax_draws():
    """The JAX Initializer's draws: PRNGKey(0), split once per essential
    solve, Gumbel [64, L] f32."""
    key = [jax.random.PRNGKey(0)]

    def draw(shape):
        key[0], sub = jax.random.split(key[0])
        return torch.from_numpy(np.asarray(jax.random.gumbel(sub, shape, jnp.float32)))

    return draw


def port_estimator():
    est = TEstimator(convert.vins_config(make_cfg()), imu_buf_len=64, device="cpu")
    est.initializer.gumbel = jax_draws()
    return est


def replay(est, calls):
    """Feed recorded calls; returns [(kind, t, p_newest or None)] per image."""
    out = []
    for kind, args in calls:
        if kind == "imu":
            est.process_imu(*args)
            continue
        ev = est.process_image(*args)
        p = est.p[est.W].copy() if est.solver_flag == NON_LINEAR else None
        out.append((ev["kind"], args[4], p))
    return out


@pytest.fixture(scope="module")
def runs():
    jest = JEstimator(make_cfg(), imu_buf_len=64)
    calls, handoff = [], {}
    imu, image = jest.process_imu, jest.process_image

    def rec_imu(dt, acc, gyr):
        calls.append(("imu", (dt, np.array(acc), np.array(gyr))))
        return imu(dt, acc, gyr)

    def rec_image(ids, pts, vels, uvs, t, toffs=0.0):
        calls.append(("img", (np.array(ids), np.array(pts), np.array(vels), np.array(uvs), t)))
        ev = image(ids, pts, vels, uvs, t, toffs)
        if sum(k == "img" for k, _ in calls) == HANDOFF:
            handoff["est"] = convert.estimator_state(jest, port_estimator())
            handoff["at"] = len(calls)
        return ev

    jest.process_imu, jest.process_image = rec_imu, rec_image
    driver = SyntheticDriver(imu_hz=200.0, frame_hz=10.0, g_norm=9.81)
    jrun = driver.run(jest, n_frames=N_FRAMES)
    test = port_estimator()
    tout = replay(test, calls)
    hout = replay(handoff["est"], calls[handoff["at"]:])
    return dict(driver=driver, jrun=jrun, jest=jest, calls=calls, test=test, tout=tout,
                hout=hout)


def test_event_kinds_match_jax(runs):
    jk = [e["kind"] for e in runs["jrun"].events]
    tk = [k for k, _, _ in runs["tout"]]
    assert tk == jk
    i0 = tk.index("initialized")
    assert all(k == "vio" for k in tk[i0 + 1:]), tk


def test_trajectory_matches_jax(runs):
    jp = runs["jrun"].p_est
    tp = np.stack([p if p is not None else np.full(3, np.nan) for _, _, p in runs["tout"]])
    np.testing.assert_array_equal(np.isnan(tp), np.isnan(jp))
    m = ~np.isnan(jp[:, 0])
    assert m.sum() >= 10
    assert np.abs(tp[m] - jp[m]).max() < TRAJ_TOL
    for f in ("p", "q", "v", "ba", "bg"):
        np.testing.assert_allclose(getattr(runs["test"], f), getattr(runs["jest"], f),
                                   rtol=0, atol=TRAJ_TOL, err_msg=f)


def test_estimate_meets_reference_bounds(runs):
    """The bounds of tests/test_estimator_e2e.py on the port's estimate."""
    jrun, test = runs["jrun"], runs["test"]
    p_est = np.stack([p if p is not None else np.full(3, np.nan) for _, _, p in runs["tout"]])
    err = ate_rmse(SimRun(t=jrun.t, p_gt=jrun.p_gt, q_gt=jrun.q_gt, p_est=p_est,
                          q_est=jrun.q_est, events=[]))
    assert err < 0.05, err
    assert np.allclose(test.bg[test.W], [0.002, 0.003, -0.001], atol=5e-4), test.bg[test.W]
    assert np.allclose(test.ba[test.W], [0.02, -0.01, 0.015], atol=5e-2), test.ba[test.W]
    v_gt = np.asarray(runs["driver"].traj.vel(jnp.asarray(jrun.t[-1], jnp.float64)))
    assert abs(np.linalg.norm(test.v[test.W]) - np.linalg.norm(v_gt)) < 0.05


def test_continues_from_jax_state(runs):
    """A port Estimator made from the JAX one's state at frame 18 follows
    the JAX run over the remaining frames."""
    jp = runs["jrun"].p_est[HANDOFF:]
    hp = np.stack([p for _, _, p in runs["hout"]])
    assert [k for k, _, _ in runs["hout"]] == ["vio"] * (N_FRAMES - HANDOFF)
    assert np.abs(hp - jp).max() < TRAJ_TOL


def test_failure_recovery(runs):
    """Feature dropout trips failureDetection → clearState → back to
    INITIAL (estimator.cpp:621-667, 193-201), as tests/test_estimator_e2e.py
    :72-88 checks on the JAX Estimator."""
    est = port_estimator()
    n_img, calls = 0, []
    for c in runs["calls"]:
        n_img += c[0] == "img"
        if n_img > 20:
            break
        calls.append(c)
    replay(est, calls)
    assert est.solver_flag == NON_LINEAR
    t = 1.0 + 20 / 10.0
    for k in range(3):
        for _ in range(20):
            est.process_imu(1.0 / 200.0, np.array([0, 0, 9.81]), np.zeros(3))
        est.process_image(np.array([], np.int64), np.zeros((0, 2)), np.zeros((0, 2)),
                          np.zeros((0, 2)), t + 0.1 * k)
    assert est.solver_flag == 0
    assert est.failures >= 1
