"""Port parity: vins_tpu_torch.solver against vins_tpu on the CPU.

A small window — the scene of `vins_tpu.sim.window.build_window_problem`
(the figure-8, the forward camera, landmarks in a shell, exact IMU at
200 Hz), built here with numpy and the port's trajectory and
preintegration, because `build_window_problem` runs op by op (~25 s) —
with 6 frames and 96 landmark slots, perturbed states, a valid prior from
one MARGIN_OLD and a relo match on half the active landmarks, goes through
the JAX functions (each jitted once) and the port's, in float64.

Tolerances: the normal equations agree to 1e-9 relative to their largest
entry (reduction order of the einsums and the jacfwd chain); a solve to
1e-7 (eight damped Cholesky steps amplify the assembly's rounding by the
reduced system's conditioning); the marginal priors, compared as JᵀJ and
Jᵀr0 (QR may flip R's row signs), to 1e-8 relative."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vins_tpu.imu.preintegration import Preintegration as JPre
from vins_tpu.sim.window import R_IC_FORWARD, WindowProblem, perturb_state
from vins_tpu.solver.problem import FeatureObs as JObs
from vins_tpu.solver import gn as jgn
from vins_tpu.solver import marginalize as jmarg
from vins_tpu.solver.problem import Layout as JLayout
from vins_tpu.solver.problem import Prior as JPrior
from vins_tpu.solver.problem import WindowState as JState
from vins_tpu_torch import convert
from vins_tpu_torch.core import nplie
from vins_tpu_torch.imu.preintegration import ImuNoise, preintegrate
from vins_tpu_torch.sim.synthetic import Trajectory
from vins_tpu_torch.solver import gn as tgn
from vins_tpu_torch.solver import marginalize as tmarg
from vins_tpu_torch.solver.problem import Layout
from vins_tpu_torch.solver.problem import Prior as TPrior

torch.set_num_threads(1)
F, L = 6, 96
JL, TL = JLayout(F), Layout(F)
OPTS = jgn.SolverOptions(iters=6)
TOPTS = tgn.SolverOptions(iters=6)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def window_problem(frames: int, max_landmarks: int, seed: int, t0: float = 1.0,
                   frame_dt: float = 0.1, imu_hz: float = 200.0) -> WindowProblem:
    """The exact window problem of `build_window_problem` (ground-truth
    states, masked feature grid, preintegrations at the true biases), as
    JAX arrays: figure-8 poses and velocities and the IMU from the port's
    `Trajectory`, landmarks from `np.random.default_rng(seed)`."""
    traj = Trajectory.figure8()
    g = np.array([0.0, 0.0, 9.81])
    tic, R_ic = np.array([0.06, -0.01, 0.02]), np.asarray(R_IC_FORWARD)
    ba, bg = np.array([0.02, -0.01, 0.015]), np.array([0.002, 0.003, -0.001])
    times = t0 + np.arange(frames) * frame_dt
    p = np.stack([traj.pos_fn(t).numpy() for t in times])
    q = np.stack([traj.q(t).numpy() for t in times])
    v = np.stack([traj.vel(t).numpy() for t in times])
    rng = np.random.default_rng(seed)
    points = np.array([0.0, 0.0, 0.8]) + rng.uniform(-1, 1, (max_landmarks, 3)) * [14, 14, 3]
    R_b = nplie.q2R(q)                                                   # [F,3,3]
    P_c = np.einsum("ji,fkj,lfk->lfi", R_ic, R_b, points[:, None] - p[None]) - tic @ R_ic
    z = P_c[..., 2]
    pt = P_c[..., :2] / np.where(np.abs(z) < 1e-9, 1e-9, z)[..., None]
    valid = (z > 0.3) & (np.abs(pt) < 1.0).all(-1)
    anchor = np.argmax(valid, axis=1)
    active = (valid.sum(1) >= 2) & (anchor < frames - 2)
    lam = 1.0 / np.maximum(z[np.arange(max_landmarks), anchor], 1e-3)
    n_max = int(round(frame_dt * imu_hz)) + 2
    ts = np.minimum(times[:-1, None] + np.arange(n_max + 1)[None] / imu_hz, times[1:, None])
    acc, gyr = traj.imu_at_times(torch.from_numpy(ts.reshape(-1)), torch.from_numpy(g))
    acc = acc.numpy().reshape(frames - 1, n_max + 1, 3) + ba
    gyr = gyr.numpy().reshape(frames - 1, n_max + 1, 3) + bg
    dt = np.diff(ts, axis=1)
    mask = np.arange(n_max)[None] < int(round(frame_dt * imu_hz))
    mask = np.broadcast_to(mask, dt.shape).copy()
    T = torch.from_numpy
    pres = preintegrate(T(dt), T(acc), T(gyr), T(ba).expand(frames - 1, 3),
                        T(bg).expand(frames - 1, 3), ImuNoise(), T(mask))
    j = jnp.asarray
    state = JState(p=j(p), q=j(q), v=j(v), ba=j(np.tile(ba, (frames, 1))),
                   bg=j(np.tile(bg, (frames, 1))), tic=j(tic), qic=j(nplie.R2q(R_ic)),
                   td=j(0.0))
    obs = JObs(pt=j(pt), vel=j(np.zeros_like(pt)), toff=j(np.zeros(valid.shape)),
               valid=j(valid), anchor=j(anchor.astype(np.int32)), inv_depth=j(lam),
               active=j(active))
    return WindowProblem(state, obs, JPre(*[j(x.numpy()) for x in pres]), j(g), j(times),
                         j(points), j(dt), j(acc), j(gyr), j(mask))


@functools.lru_cache(maxsize=None)
def window_case():
    """The window problem, its perturbed states, a valid prior (the true
    window marginalized once: a fine linear factor in the slid layout of the
    same shape) and a relo match on half the active landmarks; shared with
    test_torch_step.py."""
    prob = window_problem(F, L, seed=11)
    s0 = perturb_state(prob.state_true, jax.random.PRNGKey(4), pos_sigma=0.02, rot_sigma=0.01,
                       vel_sigma=0.02, bias_sigma=0.001)
    # the port makes it (test_marginalize_old_matches_jax holds that step)
    tp = tmarg.marginalize_old(
        convert.window_state(prob.state_true, "cpu"), convert.feature_obs(prob.obs, "cpu"),
        convert.preintegration(prob.pres, "cpu"), TPrior.empty(TL), torch.from_numpy(
            np.array(prob.gravity)), TL)
    prior = JPrior(J=jnp.asarray(tp.J.numpy()), r0=jnp.asarray(tp.r0.numpy()),
                   lin=JState(*[jnp.asarray(x.numpy()) for x in tp.lin]),
                   valid=jnp.asarray(True))
    rng = np.random.default_rng(5)
    relo_valid = np.asarray(prob.obs.active) & (rng.random(L) < 0.5)
    relo_pt = np.asarray(prob.obs.pt[:, F - 2]) + 1e-3 * rng.standard_normal((L, 2))
    relo = (np.asarray(prob.state_true.p[F - 2]) + 0.01, np.asarray(prob.state_true.q[F - 2]),
            relo_pt, relo_valid)
    return prob, s0, prior, relo


@pytest.fixture(scope="module")
def case():
    prob, s0, prior, relo = window_case()
    relo = relo + (1.0,)
    col_mask = np.ones(JL.dim_x + 6)
    col_mask[JL.ext_off:JL.ext_off + 7] = 0.0
    jargs = (s0, prob.obs.inv_depth * 1.05, prob.obs, prob.pres, prior, prob.gravity)
    targs = (convert.window_state(s0, "cpu"), torch.from_numpy(np.array(jargs[1])),
             convert.feature_obs(prob.obs, "cpu"), convert.preintegration(prob.pres, "cpu"),
             convert.prior(prior, "cpu"), torch.from_numpy(np.array(prob.gravity)))
    trelo = tuple(torch.from_numpy(np.array(x)) for x in relo[:4]) + (relo[4],)
    return dict(prob=prob, jargs=jargs, targs=targs, relo=relo, trelo=trelo,
                col_mask=col_mask)


@pytest.mark.parametrize("with_relo", [False, True])
def test_normal_equations_match_jax(case, with_relo):
    cm = case["col_mask"] if with_relo else case["col_mask"][:JL.dim_x]
    jre = tuple(jnp.asarray(x) for x in case["relo"]) if with_relo else None
    tre = case["trelo"] if with_relo else None
    jout = jax.jit(lambda *a: jgn.build_normal_equations(*a, JL, OPTS, jnp.asarray(cm),
                                                         relo_eval=jre))(*case["jargs"])
    tout = tgn.build_normal_equations(*case["targs"], TL, TOPTS, torch.from_numpy(cm),
                                      relo_eval=tre)
    for name, a, b in zip(("H", "b", "H_xl", "H_ll", "b_l"), tout, jout):
        assert rel(a.numpy(), b) < 1e-9, (name, rel(a.numpy(), b))


@pytest.mark.parametrize("with_relo", [True])
def test_solve_window_matches_jax(case, with_relo):
    s0, lam, obs, pres, prior, g = case["jargs"]
    ts0, tlam, tobs, tpres, tprior, tg = case["targs"]
    jre = tuple(jnp.asarray(x) for x in case["relo"]) if with_relo else None
    tre = case["trelo"] if with_relo else None
    jout = jax.jit(lambda s, o: jgn.solve_window(s, o, pres, prior, g, JL, OPTS, relo=jre))(
        s0, obs._replace(inv_depth=lam))
    tout = tgn.solve_window(ts0, tobs._replace(inv_depth=tlam), tpres, tprior, tg, TL, TOPTS,
                            relo=tre)
    jst, tst = jout[0], tout[0]
    for f in ("p", "q", "v", "ba", "bg"):
        np.testing.assert_allclose(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)),
                                   rtol=0, atol=1e-7, err_msg=f)
    act = np.asarray(obs.active)
    np.testing.assert_allclose(tout[1].numpy()[act], np.asarray(jout[1])[act], rtol=1e-7)
    assert rel(tout[2].cost.numpy(), jout[2].cost) < 1e-7
    np.testing.assert_array_equal(tout[2].accepted.numpy(), np.asarray(jout[2].accepted))
    assert np.asarray(jout[2].cost) < np.asarray(jout[2].cost0)
    if with_relo:
        np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]), atol=1e-7)
        np.testing.assert_allclose(tout[4].numpy(), np.asarray(jout[4]), atol=1e-7)


def _same_prior(tp, jp):
    J, r = tp.J.numpy(), tp.r0.numpy()
    Jj, rj = np.asarray(jp.J), np.asarray(jp.r0)
    # (‖r0‖² itself is not compared: where the stacked rows are rank
    # deficient, the part of the right-hand side outside their range lands
    # in rows of R that differ between QR implementations; it is a constant
    # of the cost and moves no solve)
    assert rel(J.T @ J, Jj.T @ Jj) < 1e-8
    assert rel(J.T @ r, Jj.T @ rj) < 1e-8
    for f in ("p", "q", "v", "ba", "bg", "tic", "qic", "td"):
        np.testing.assert_allclose(getattr(tp.lin, f).numpy(), np.asarray(getattr(jp.lin, f)),
                                   rtol=0, atol=1e-12)
    assert bool(tp.valid) == bool(jp.valid)


def test_marginalize_old_matches_jax(case):
    s0, lam, obs, pres, prior, g = case["jargs"]
    ts0, tlam, tobs, tpres, tprior, tg = case["targs"]
    jp = jax.jit(lambda s, o: jmarg.marginalize_old(s, o, pres, prior, g, JL))(
        s0, obs._replace(inv_depth=lam))
    tp = tmarg.marginalize_old(ts0, tobs._replace(inv_depth=tlam), tpres, tprior, tg, TL)
    _same_prior(tp, jp)


def test_marginalize_second_new_matches_jax(case):
    prior, tprior = case["jargs"][4], case["targs"][4]
    jp = jax.jit(lambda p: jmarg.marginalize_second_new(p, JL))(prior)
    tp = tmarg.marginalize_second_new(tprior, TL)
    _same_prior(tp, jp)
    # the column moves: frame F-2's pose columns hold what F-1's held
    J = tp.J.numpy()
    assert np.abs(J[:, 6 * (F - 1):6 * F]).max() == 0.0
