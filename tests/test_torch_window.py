"""Port parity: vins_tpu_torch.sim.window (`build_window_problem`) and
the sim/synthetic functions it uses against vins_tpu on the CPU, and the
online td and rolling-shutter recovery of tests/test_td.py through the
port's solve.

The port's draws (landmarks, pixel and IMU noise, the perturbation) come
from a torch.Generator, JAX's from jax.random, so the rest is compared on
shared draws: JAX's `build_window_problem` is run once, on the port's points
(seed 0) in place of its own draw, and JAX's normal draws are fed to the
port's perturbation.  The states, times, raw IMU and preintegrations do not
depend on the points.  JAX's eager builder takes ~25 s on its first call
whatever the shape (it compiles each op), so the file builds it once.

Tolerances (float64): the trajectory, IMU and projections agree to 1e-12
(the same closed forms, differentiated by jacfwd in both packages); the
preintegrations to 1e-9 relative to their largest entry (the associative
scans' order); the td solves to 1e-7 (ten damped Cholesky solves, as
test_torch_solver)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vins_tpu.sim import synthetic as jsyn
from vins_tpu.sim import window as jwindow
from vins_tpu.solver import gn as jgn
from vins_tpu.solver.problem import Layout as JLayout
from vins_tpu.solver.problem import Prior as JPrior
from vins_tpu_torch import convert
from vins_tpu_torch.imu.preintegration import ImuNoise
from vins_tpu_torch.sim import synthetic as tsyn
from vins_tpu_torch.sim import window as twindow
from vins_tpu_torch.solver import gn as tgn
from vins_tpu_torch.solver.problem import Layout, Prior

torch.set_num_threads(1)
F, L = 11, 96
TD_TRUE, TR, ROWS = 0.015, 0.030, 480


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.fixture(scope="module")
def tprob():
    return twindow.build_window_problem(frames=F, max_landmarks=L, seed=0, device="cpu")


@pytest.fixture(scope="module")
def jprob(tprob):
    """JAX's window problem on the port's landmarks."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwindow, "make_landmarks",
                   lambda key, n, **kw: jnp.asarray(tprob.points.numpy()))
        return jwindow.build_window_problem(frames=F, max_landmarks=L, dtype=jnp.float64)


def test_r_ic_forward_is_jax():
    assert twindow.R_IC_FORWARD == jwindow.R_IC_FORWARD
    from vins_tpu_torch.sim import euroc_writer, proxy

    assert proxy.R_IC_FORWARD is twindow.R_IC_FORWARD
    assert euroc_writer.R_IC_FORWARD is twindow.R_IC_FORWARD


@pytest.mark.parametrize("part", ["state_true", "times_gravity", "raw_imu", "pres"])
def test_window_problem_matches_jax_where_draws_do_not_reach(jprob, tprob, part):
    if part == "state_true":
        for f in tprob.state_true._fields:
            np.testing.assert_allclose(getattr(tprob.state_true, f).numpy(),
                                       np.asarray(getattr(jprob.state_true, f)), rtol=0,
                                       atol=1e-12, err_msg=f)
    elif part == "times_gravity":
        np.testing.assert_array_equal(tprob.times.numpy(), np.asarray(jprob.times))
        np.testing.assert_array_equal(tprob.gravity.numpy(), np.asarray(jprob.gravity))
    elif part == "raw_imu":
        np.testing.assert_array_equal(tprob.raw_mask.numpy(), np.asarray(jprob.raw_mask))
        for f in ("raw_dt", "raw_acc", "raw_gyr"):
            np.testing.assert_allclose(getattr(tprob, f).numpy(), np.asarray(getattr(jprob, f)),
                                       rtol=0, atol=1e-12, err_msg=f)
    else:
        for f in tprob.pres._fields:
            assert rel(getattr(tprob.pres, f).numpy(), getattr(jprob.pres, f)) < 1e-9, f


def test_project_points_matches_jax(jprob):
    st = jprob.state_true
    pts = np.asarray(jprob.points)
    t = convert.window_state(st, "cpu")
    tp, tv = tsyn.project_points(t.p, t.q, t.tic, t.qic, torch.from_numpy(pts))
    for f in range(F):
        jp, jv = jsyn.project_points(st.p[f], st.q[f], st.tic, st.qic, jprob.points)
        np.testing.assert_allclose(tp[f].numpy(), np.asarray(jp), rtol=0, atol=1e-12)
        np.testing.assert_array_equal(tv[f].numpy(), np.asarray(jv))
    assert 0 < int(tv.sum()) < tv.numel()


def jax_velocities(prob):
    """JAX's `feature_velocity` at each frame time: [L, F, 2]."""
    st = prob.state_true
    traj = jsyn.Trajectory.figure8()
    fn = jax.jit(lambda t: jsyn.feature_velocity(traj, t, st.tic, st.qic, prob.points))
    return jnp.stack([fn(float(t)) for t in np.asarray(prob.times)], axis=1)


def port_velocities(prob):
    st = prob.state_true
    traj = tsyn.Trajectory.figure8()
    return torch.stack([tsyn.feature_velocity(traj, float(t), st.tic, st.qic, prob.points)
                        for t in prob.times], dim=1)


@pytest.fixture(scope="module")
def velocities(jprob):
    return jax_velocities(jprob), port_velocities(convert.window_problem(jprob, "cpu"))


def test_feature_velocity_matches_jax(velocities):
    jv, tv = velocities
    assert np.max(np.abs(np.asarray(jv))) > 0.1
    # landmarks near the image plane move fast (∝ 1/z²): relative
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-12, atol=1e-12)


def test_obs_assembly_on_the_ports_points(jprob, tprob):
    """The port's landmarks fed to JAX's `build_window_problem` in place of
    its draw: the feature grid, anchors, activity and inverse depths agree."""
    jp, tp = jprob, tprob
    np.testing.assert_array_equal(np.asarray(jp.points), tp.points.numpy())
    for f in ("valid", "anchor", "active"):
        np.testing.assert_array_equal(getattr(tp.obs, f).numpy(), np.asarray(getattr(jp.obs, f)),
                                      err_msg=f)
    for f in ("pt", "vel", "toff", "inv_depth"):
        np.testing.assert_allclose(getattr(tp.obs, f).numpy(), np.asarray(getattr(jp.obs, f)),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    assert 10 <= int(tp.obs.active.sum()) < L


def test_perturb_state_matches_jax_on_the_same_draws(jprob):
    key = jax.random.PRNGKey(11)
    js = jwindow.perturb_state(jprob.state_true, key, pos_sigma=0.02, rot_sigma=0.01)
    ks = jax.random.split(key, 5)
    z = np.stack([np.asarray(jax.random.normal(k, (F, 3), jnp.float64)) for k in ks])
    ts = twindow.perturb_state_by(convert.window_state(jprob.state_true, "cpu"),
                                  torch.from_numpy(z), pos_sigma=0.02, rot_sigma=0.01)
    for f in ts._fields:
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), rtol=0,
                                   atol=1e-12, err_msg=f)
    assert np.array_equal(ts.p[0].numpy(), np.asarray(jprob.state_true.p[0]))  # frame 0 held


def test_the_ports_draws(tprob):
    """Draw-dependent parts, the port alone: a seed gives one problem on
    every call; the IMU noise has the densities' scale."""
    a = twindow.build_window_problem(frames=6, max_landmarks=32, seed=5, imu_noise=True,
                                     pix_noise=0.01, device="cpu")
    b = twindow.build_window_problem(frames=6, max_landmarks=32, seed=5, imu_noise=True,
                                     pix_noise=0.01, device="cpu")
    c = twindow.build_window_problem(frames=6, max_landmarks=32, seed=5, device="cpu")
    for x, y in zip((a.points, a.obs.pt, a.raw_acc, a.raw_gyr), (b.points, b.obs.pt, b.raw_acc,
                                                               b.raw_gyr)):
        assert torch.equal(x, y)
    assert torch.equal(a.points, c.points)
    noise = ImuNoise()
    assert 0.5 < float((a.raw_acc - c.raw_acc).std()) / noise.acc_n < 1.5
    assert 0.5 < float((a.raw_gyr - c.raw_gyr).std()) / noise.gyr_n < 1.5
    assert 0.5 < float((a.obs.pt - c.obs.pt).std()) / 0.01 < 1.5
    s = twindow.perturb_state(tprob.state_true, 2)
    assert torch.equal(s.p, twindow.perturb_state(tprob.state_true, 2).p)
    assert torch.equal(s.p[0], tprob.state_true.p[0]) and not torch.equal(s.p, tprob.state_true.p)


# ---- online td and rolling shutter (tests/test_td.py:18-102) -------------------------

@pytest.fixture(scope="module")
def td_case(jprob, velocities):
    """The hidden-offset observations in both packages, and JAX's solve of
    the window jitted once (both tests share its shapes)."""
    jv, tv = velocities
    layout = JLayout(F)
    extra = jnp.zeros((layout.dim_x,), jnp.float64).at[:6].set(1e12)  # gauge: pin frame 0
    st = jprob.state_true
    jsolve = jax.jit(lambda obs: jgn.solve_window(
        st, obs, jprob.pres, JPrior.empty(layout, jnp.float64), jprob.gravity, layout,
        jgn.SolverOptions(iters=10), estimate_td=True, extra_diag=extra))
    tp = convert.window_problem(jprob, "cpu")
    tl = Layout(F)

    def tsolve(obs):
        return tgn.solve_window(tp.state_true, obs, tp.pres, Prior.empty(tl), tp.gravity, tl,
                                tgn.SolverOptions(iters=10), estimate_td=True,
                                extra_diag=torch.from_numpy(np.asarray(extra)))

    rows = np.random.default_rng(3).uniform(0, ROWS, size=(L, F))
    return dict(jv=jv, tv=tv, jsolve=jsolve, tsolve=tsolve, tp=tp, rs_off=TR * (rows / ROWS - 0.5))


def check_td(td_case, jobs, tobs, td_true):
    c = td_case
    js, jlam, jinfo = c["jsolve"](jobs)
    ts, tlam, tinfo = c["tsolve"](tobs)
    assert abs(float(ts.td) - td_true) < 1e-4, float(ts.td)
    assert float(tinfo.cost) < 1e-6
    assert float((ts.p - c["tp"].state_true.p).abs().max()) < 1e-3
    for f in ts._fields:
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), rtol=0,
                                   atol=1e-7, err_msg=f)
    act = c["tp"].obs.active.numpy()
    np.testing.assert_allclose(tlam.numpy()[act], np.asarray(jlam)[act], rtol=1e-7)
    return tinfo


def test_td_recovered(jprob, td_case):
    c = td_case
    jobs = jprob.obs._replace(pt=jprob.obs.pt + TD_TRUE * c["jv"], vel=c["jv"])
    tobs = c["tp"].obs._replace(pt=c["tp"].obs.pt + TD_TRUE * c["tv"], vel=c["tv"])
    check_td(c, jobs, tobs, TD_TRUE)


def test_rolling_shutter_toff_recovers_td(jprob, td_case):
    c = td_case
    td_true, rs_off = 0.010, c["rs_off"]
    jobs = jprob.obs._replace(pt=jprob.obs.pt + (td_true + rs_off)[:, :, None] * c["jv"],
                              vel=c["jv"], toff=jnp.asarray(-rs_off))
    shift = torch.from_numpy(td_true + rs_off)[:, :, None] * c["tv"]
    tobs = c["tp"].obs._replace(pt=c["tp"].obs.pt + shift, vel=c["tv"],
                                toff=torch.from_numpy(-rs_off))
    info = check_td(c, jobs, tobs, td_true)
    # control: the rolling-shutter term dropped leaves a biased, costlier solve
    _, _, info0 = c["tsolve"](tobs._replace(toff=torch.zeros_like(tobs.toff)))
    assert float(info0.cost) > 10 * float(info.cost)
