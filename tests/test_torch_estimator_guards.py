"""Port parity: the estimator's guards against vins_tpu's on the CPU.

  * the IMU overflow guard (`_overflow_guard`) on the three cases of
    tests/test_estimator_e2e.py:91-104, and the counted, warned overflow of
    `process_imu` (:107-115);
  * the post-init health monitor (`_init_health_check`) on the cost
    sequences of tests/test_init_health.py:27-44 and on medians just below
    and just above `INIT_COST_MAX`, its re-arm after `clear_state` and its
    three constants;
  * extrinsic calibration from scratch (ESTIMATE_EXTRINSIC = 2,
    `_calibrate_extrinsic`): the JAX driver's call stream into a JAX
    `Estimator` is replayed into the port's with JAX's RANSAC draws
    (`jax.random.gumbel(PRNGKey(frame_count), (64, L), f32)`) injected
    through `ex_gumbel`.  On the default figure-8 the reference never
    accepts a calibration (its 64-pair ring keeps the second-smallest
    singular value under 0.25, ROADMAP Queue 3): 30 frames hold the port
    to the same outcome, pair by pair.  On a figure-8 of period 5 s it
    accepts at frame 35: the port must accept there too."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vins_tpu.config import VinsConfig as JConfig
from vins_tpu.core import nplie
from vins_tpu.estimator.estimator import Estimator as JEstimator
from vins_tpu.sim.driver import SyntheticDriver
from vins_tpu.sim.synthetic import Trajectory
from vins_tpu.sim.window import R_IC_FORWARD
from vins_tpu_torch import convert
from vins_tpu_torch.estimator.estimator import Estimator as TEstimator

torch.set_num_threads(1)
PAIR_TOL = 1e-9   # the buffered pair rotations, float64 on both sides
RIC_TOL = 1e-6    # rad, the calibrated rotation


def make_cfg(**kw):
    kw = dict(dict(max_landmarks=160, extrinsic_t=(0.06, -0.01, 0.02)), **kw)
    return JConfig(g_norm=9.81, extrinsic_R=R_IC_FORWARD, **kw)


def pair(imu_buf_len: int, **kw):
    """A JAX and a port Estimator of the same config."""
    cfg = make_cfg(**kw)
    return (JEstimator(cfg, imu_buf_len=imu_buf_len),
            TEstimator(convert.vins_config(cfg), imu_buf_len=imu_buf_len, device="cpu"))


def guard_answers(est):
    """tests/test_estimator_e2e.py:91-104 on one Estimator."""
    est.frame_count = est.W
    est.imu_n[est.W - 2] = 10
    est.imu_n[est.W - 1] = 9
    out = [est._overflow_guard()]          # 10 + 9 > 16: force MARGIN_OLD
    est.imu_n[est.W - 1] = 5
    out.append(est._overflow_guard())      # fits: the parallax rule decides
    est.frame_count = 3                    # window still filling: no merge
    est.imu_n[est.W - 1] = 99
    out.append(est._overflow_guard())
    return out


def test_overflow_guard_matches_jax():
    j, t = pair(16)
    assert guard_answers(t) == guard_answers(j) == [True, False, False]


def overflow_run(est):
    """tests/test_estimator_e2e.py:107-115 on one Estimator."""
    est.frame_count = 1
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(8):
            est.process_imu(0.005, np.array([0.0, 0, 9.81]), np.zeros(3))
    kinds = [w.category for w in caught]
    return kinds, est.imu_overflow, est.imu_n.copy(), est.imu_dt.copy(), est.imu_acc.copy()


def test_counted_overflow_matches_jax():
    j, t = pair(4)
    jk, jo, jn, jdt, jacc = overflow_run(j)
    tk, to, tn, tdt, tacc = overflow_run(t)
    assert tk == jk == [RuntimeWarning]    # warned once, at the first drop
    assert to == jo == 4                   # 8 samples into 4 slots
    np.testing.assert_array_equal(tn, jn)
    assert tn[0] == 4
    np.testing.assert_array_equal(tdt, jdt)
    np.testing.assert_array_equal(tacc, jacc)


HEALTH = {
    "pathological": [5.0e6] * 12,
    "healthy": list(np.linspace(300.0, 2300.0, 17)),
    "median_just_below": [5.0e6] * 4 + [0.999e5] * 8,
    "median_just_above": [1.0] * 4 + [1.001e5] * 8,
    "even_median_averages": [1.0] * 4 + [1.0e3] * 4 + [1.0e7] * 4,
}


@pytest.mark.parametrize("case", list(HEALTH))
def test_health_monitor_matches_jax(case):
    """Same answer for every cost, the same re-arm after `clear_state`."""
    j, t = pair(16, max_landmarks=64)
    costs = HEALTH[case]
    ja = [j._init_health_check(float(c)) for c in costs]
    ta = [t._init_health_check(float(c)) for c in costs]
    assert ta == ja
    verdict = {"pathological": False, "healthy": True, "median_just_below": True,
               "median_just_above": False, "even_median_averages": False}[case]
    assert ta[j.INIT_HEALTH_FRAMES - 1] is verdict
    assert all(ta[: j.INIT_HEALTH_FRAMES - 1]) and all(ta[j.INIT_HEALTH_FRAMES:])
    j.clear_state()
    t.clear_state()
    assert t._init_health_check(5.0e6) == j._init_health_check(5.0e6) is True


def test_health_constants_match_jax():
    for name in ("INIT_HEALTH_FRAMES", "INIT_HEALTH_SKIP", "INIT_COST_MAX"):
        assert getattr(TEstimator, name) == getattr(JEstimator, name), name


def jax_ex_draws(shape, seed):
    """The reference's draw in `_calibrate_extrinsic`: PRNGKey(frame_count)."""
    return torch.from_numpy(np.array(
        jax.random.gumbel(jax.random.PRNGKey(seed), shape, jnp.float32)))


def ex_state(est):
    b = est._ex_buf
    return dict(flag=int(est.estimate_extrinsic), head=int(b.head), used=np.array(b.used),
                q_cam=np.array(b.q_cam), q_imu=np.array(b.q_imu), ric=np.array(b.ric),
                qic=np.array(est.qic))


def angle(q1, q2) -> float:
    """The rotation angle between two unit quaternions, in rad (atan2, so
    small angles keep their digits)."""
    d = nplie.qmul(nplie.qconj(np.asarray(q1)), np.asarray(q2))
    return float(2.0 * np.arctan2(np.linalg.norm(d[1:]), abs(d[0])))


# (figure-8 period s, frames, the frame that accepts in vins_tpu: measured,
# 1-based; None: never).  The default scene rotates too gently for the
# reference's 64-pair ring; a period of 5 s excites it enough.
EX_SCENES = {"default": (20.0, 30, None), "excited": (5.0, 36, 35)}


@pytest.fixture(scope="module", params=list(EX_SCENES))
def ex_runs(request):
    """ESTIMATE_EXTRINSIC = 2 through both estimators: the JAX one on the
    JAX driver, the port one on the recorded calls; the calibration state
    after every image.  Initialization is held elsewhere, so both
    estimators' `_try_initialize` only records its frame and declines:
    no VIO step runs, and the calibration is compared alone up to one
    frame after the reference accepts."""
    period, n_frames, _ = EX_SCENES[request.param]
    jest = JEstimator(make_cfg(estimate_extrinsic=2), imu_buf_len=64)
    test = TEstimator(convert.vins_config(make_cfg(estimate_extrinsic=2)), imu_buf_len=64,
                      device="cpu")
    test.ex_gumbel = jax_ex_draws
    imu, image = jest.process_imu, jest.process_image
    out = {"scene": request.param, "jax": [], "port": [], "jkinds": [], "tkinds": [],
           "jinit": [], "tinit": []}
    jest._try_initialize = lambda: out["jinit"].append(len(out["jax"])) or False
    test._try_initialize = lambda: out["tinit"].append(len(out["port"])) or False

    def rec_imu(dt, acc, gyr):
        test.process_imu(dt, np.array(acc), np.array(gyr))
        return imu(dt, acc, gyr)

    def rec_image(ids, pts, vels, uvs, t, toffs=0.0):
        ev = image(ids, pts, vels, uvs, t, toffs)
        out["jkinds"].append(ev["kind"])
        out["jax"].append(ex_state(jest))
        tev = test.process_image(np.array(ids), np.array(pts), np.array(vels), np.array(uvs), t)
        out["tkinds"].append(tev["kind"])
        out["port"].append(ex_state(test))
        return ev

    jest.process_imu, jest.process_image = rec_imu, rec_image
    SyntheticDriver(imu_hz=200.0, frame_hz=10.0, g_norm=9.81,
                    traj=Trajectory.figure8(period=period)).run(jest, n_frames=n_frames)
    return out


def accepted_at(states):
    """The 1-based frame whose image set estimate_extrinsic to 1, or None."""
    return next((k + 1 for k, st in enumerate(states) if st["flag"] == 1), None)


def test_extrinsic_calibration_outcome_matches_jax(ex_runs):
    """The same frame of acceptance (none on the default scene), the same
    calibrated qic to 1e-6 rad (the configured one while none), and the
    initialization tried on the same frames: from the acceptance on."""
    _, n_frames, want = EX_SCENES[ex_runs["scene"]]
    j, t = ex_runs["jax"], ex_runs["port"]
    assert [s["flag"] for s in t] == [s["flag"] for s in j]
    assert accepted_at(t) == accepted_at(j) == want
    assert ex_runs["tkinds"] == ex_runs["jkinds"]
    assert ex_runs["tinit"] == ex_runs["jinit"]
    q_fwd = nplie.R2q(np.asarray(R_IC_FORWARD, float))
    if want is None:
        assert ex_runs["tinit"] == [] and set(ex_runs["tkinds"]) == {"filling", "init_pending"}
        for st in j + t:
            np.testing.assert_array_equal(st["qic"], q_fwd)
    else:
        assert ex_runs["tinit"][0] == want - 1       # tried in the accepting frame
        assert angle(t[-1]["qic"], j[-1]["qic"]) <= RIC_TOL
        assert angle(t[-1]["qic"], q_fwd) < 0.01


def test_extrinsic_pairs_match_jax(ex_runs):
    """Every image up to the acceptance pushes the same camera/IMU rotation
    pair into the ring, and the running estimate (updated whether or not
    accepted) agrees to 1e-6 rad.  One pair constrains two degrees of
    freedom only (its 4×4 block has rank 2), so the null vector after the
    first pair is any of a plane and is not compared."""
    j, t = ex_runs["jax"], ex_runs["port"]
    last = accepted_at(j) or len(j)
    worst = 0.0
    for k, (js, ts) in enumerate(zip(j, t)):
        assert ts["head"] == js["head"] == min(k, last - 1), k
        np.testing.assert_array_equal(ts["used"], js["used"])
        for f in ("q_cam", "q_imu"):
            np.testing.assert_allclose(ts[f], js[f], rtol=0, atol=PAIR_TOL, err_msg=f"{f} @ {k}")
        if k >= 2:
            worst = max(worst, angle(ts["ric"], js["ric"]))
    assert worst <= RIC_TOL, worst
