"""Port parity: vins_tpu_torch's initialization stack against vins_tpu on
the CPU, on the cases of tests/test_init.py (the exact 11-frame synthetic
window with 128 landmarks, as test_torch_solver.window_problem builds it)
and one whole `Initializer.try_initialize` on a
SyntheticDriver window.

Tolerances (float64): PnP 1e-9 (both converge to the exact pose); SfM
poses and points 1e-7 (eigh against inverse iteration for the DLT null
vectors, then a 12-iteration BA); BA 1e-7 (measured 4e-8 on the worst
point: eight damped solves); alignment 1e-8 relative (QR
factors may differ in row signs, the solutions do not); the extrinsic
rotation 1e-10 (the SVD null vector up to sign, fixed by w ≥ 0); the
initialization's states 1e-6 (SfM + two alignments + world rotation)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vins_tpu.core import lie as jlie
from vins_tpu.estimator.estimator import Estimator as JEstimator
from vins_tpu.init import alignment as jal
from vins_tpu.init import ex_rotation as jex
from vins_tpu.init import sfm as jsfm
from vins_tpu.sim.driver import SyntheticDriver
from vins_tpu.solver import ba as jba
from tests.test_torch_solver import window_problem
from vins_tpu_torch import convert
from vins_tpu_torch.core import lie as tlie
from vins_tpu_torch.estimator.initializer import Initializer as TInitializer
from vins_tpu_torch.init import alignment as tal
from vins_tpu_torch.init import ex_rotation as tex
from vins_tpu_torch.init import sfm as tsfm
from vins_tpu_torch.solver import ba as tba

torch.set_num_threads(1)
DT = jnp.float64


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def prob():
    return window_problem(11, 128, seed=0)


def cam_poses(prob):
    st = prob.state_true
    p_c = st.p + jax.vmap(jlie.qrotate)(st.q, jnp.tile(st.tic[None], (st.p.shape[0], 1)))
    q_c = jax.vmap(lambda q: jlie.qmul(q, st.qic))(st.q)
    return p_c, q_c


def test_pnp_gn_matches_jax(prob):
    p_c, q_c = cam_poses(prob)
    f = 5
    w = prob.obs.valid[:, f].astype(DT)
    p0 = p_c[f] + jnp.asarray([0.2, -0.15, 0.1], DT)
    q0 = jlie.qmul(q_c[f], jlie.deltaQ(jnp.asarray([0.05, -0.04, 0.06], DT)))
    jp, jq, jok = jax.jit(jsfm.pnp_gn)(prob.points, prob.obs.pt[:, f], w, p0, q0)
    tp, tq, tok = tsfm.pnp_gn(T(prob.points), T(prob.obs.pt[:, f]), T(w), T(p0), T(q0))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-9)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-9)
    assert bool(tok) == bool(jok)
    np.testing.assert_allclose(tp.numpy(), np.asarray(p_c[f]), atol=1e-8)


def test_construct_sfm_matches_jax(prob):
    p_c, q_c = cam_poses(prob)
    F, l = 11, 0
    R_l = jlie.q2R(q_c[l])
    R_rel = R_l.T @ jlie.q2R(q_c[F - 1])
    t_rel = R_l.T @ (p_c[F - 1] - p_c[l])
    t_rel = t_rel / jnp.linalg.norm(t_rel)
    jr = jax.jit(jsfm.construct_sfm)(prob.obs.pt, prob.obs.valid, jnp.asarray(l), R_rel, t_rel)
    tr = tsfm.construct_sfm(T(prob.obs.pt), T(prob.obs.valid), l, T(R_rel), T(t_rel))
    np.testing.assert_array_equal(tr.has_pt.numpy(), np.asarray(jr.has_pt))
    assert bool(tr.ok) and bool(jr.ok)
    np.testing.assert_allclose(tr.p_wc.numpy(), np.asarray(jr.p_wc), atol=1e-7)
    np.testing.assert_allclose(tr.q_wc.numpy(), np.asarray(jr.q_wc), atol=1e-7)
    has = np.asarray(jr.has_pt)
    np.testing.assert_allclose(tr.pts.numpy()[has], np.asarray(jr.pts)[has], atol=1e-7)


def test_ba_solve_matches_jax(prob):
    """BA from perturbed camera poses and points, pose 0 fixed, the
    translation of the last frame fixed (the SfM gauge)."""
    p_c, q_c = cam_poses(prob)
    F = 11
    rng = np.random.default_rng(2)
    p0 = np.asarray(p_c) + 0.02 * rng.standard_normal((F, 3)) * (np.arange(F) > 0)[:, None]
    q0 = np.asarray(jax.vmap(jlie.qmul)(q_c, jax.vmap(jlie.deltaQ)(
        jnp.asarray(0.01 * rng.standard_normal((F, 3)) * (np.arange(F) > 0)[:, None]))))
    pts = np.asarray(prob.points) + 0.05 * rng.standard_normal(prob.points.shape)
    valid = np.asarray(prob.obs.valid)
    pt_mask = valid.sum(1) >= 2
    fix_pose = np.arange(F) == 0
    fix_pos = fix_pose | (np.arange(F) == F - 1)
    args = (p0, q0, pts, np.asarray(prob.obs.pt), valid, fix_pose, fix_pos, pt_mask)
    js, jc = jax.jit(lambda p, q, x, o, v, a, b, m: jba.ba_solve(
        jba.BAState(p, q, x), o, v, a, b, m, iters=8))(*args)
    ts, tc = tba.ba_solve(tba.BAState(T(p0), T(q0), T(pts)), *[T(a) for a in args[3:]], iters=8)
    np.testing.assert_allclose(ts.p.numpy(), np.asarray(js.p), atol=1e-7)
    np.testing.assert_allclose(ts.q.numpy(), np.asarray(js.q), atol=1e-7)
    np.testing.assert_allclose(ts.pts.numpy()[pt_mask], np.asarray(js.pts)[pt_mask], atol=1e-7)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-7, atol=1e-14)


def test_visual_imu_alignment_matches_jax(prob):
    st = prob.state_true
    p_c, _ = cam_poses(prob)
    p_sfm = p_c / 2.7
    jr = jax.jit(lambda *a: jal.visual_imu_alignment(*a, g_norm=9.81))(
        st.q, p_sfm, st.tic, prob.pres)
    tr = tal.visual_imu_alignment(T(st.q), T(p_sfm), T(st.tic),
                                  convert.preintegration(prob.pres, "cpu"), g_norm=9.81)
    assert bool(tr.ok) and bool(jr.ok)
    for f in ("v_body", "g_c0", "scale", "s_rel_sigma"):
        a, b = getattr(tr, f).numpy(), np.asarray(getattr(jr, f))
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8 * np.abs(b).max(), err_msg=f)
    assert abs(float(tr.scale) - 2.7) < 1e-3 * 2.7


def test_calibrate_ex_rotation_matches_jax(prob):
    q_ic = prob.state_true.qic
    rng = np.random.default_rng(7)
    jbuf, tbuf = jex.ExRotBuffer.empty(64, DT), tex.ExRotBuffer.empty(64)
    jcal = jax.jit(jex.calibrate_ex_rotation)
    for k in range(12):
        q_imu = jlie.qexp(jnp.asarray(0.4 * rng.standard_normal(3)))
        q_cam = jlie.qmul(jlie.qconj(q_ic), jlie.qmul(q_imu, q_ic))
        # a little disagreement so the Huber weights differ from 1
        q_cam = jlie.qmul(q_cam, jlie.qexp(jnp.asarray(0.002 * rng.standard_normal(3))))
        jbuf = jex.push_pair(jbuf, q_cam, q_imu)
        tbuf = tex.push_pair(tbuf, T(q_cam), T(q_imu))
        jq, jok, jbuf = jcal(jbuf)
        tq, tok, tbuf = tex.calibrate_ex_rotation(tbuf)
        assert bool(tok) == bool(jok)
        if k >= 3:  # with fewer pairs the null space has more than one dimension
            np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-10)
    assert bool(tok)
    assert abs(float(tlie.qmul(tlie.qconj(tq), T(q_ic))[0])) > 1.0 - 1e-6


def test_try_initialize_matches_jax():
    """The SyntheticDriver feeds a JAX Estimator; at its first initialization
    attempt the port's Initializer runs on the same feature DB and IMU
    buffers (with the JAX initializer's RANSAC draws) and must give the same
    result."""
    import copy

    from vins_tpu.config import VinsConfig
    from vins_tpu.sim.window import R_IC_FORWARD

    cfg = VinsConfig(max_landmarks=160, g_norm=9.81, extrinsic_R=R_IC_FORWARD,
                     extrinsic_t=(0.06, -0.01, 0.02))
    est = JEstimator(cfg, imu_buf_len=64)
    key = [jax.random.PRNGKey(0)]

    def jax_draws(shape):
        key[0], sub = jax.random.split(key[0])
        return T(jax.random.gumbel(sub, shape, jnp.float32))

    ti = TInitializer(convert.imu_noise(est.noise), 9.81, device="cpu", gumbel=jax_draws)
    results = []
    jtry = est.initializer.try_initialize

    class Done(Exception):
        pass

    def both(db, *args, **kw):
        tr = ti.try_initialize(copy.deepcopy(db), *copy.deepcopy(args), **kw)
        results.append((jtry(db, *args, **kw), tr))
        raise Done  # stop before the JAX window step (its compile is not needed here)

    est.initializer.try_initialize = both
    with pytest.raises(Done):
        SyntheticDriver().run(est, n_frames=12)
    jr, tr = results[0]
    assert jr.ok and tr.ok and jr.reason == tr.reason, (jr.reason, tr.reason)
    for f in ("p", "q", "v", "bg"):
        np.testing.assert_allclose(getattr(tr, f), getattr(jr, f), atol=1e-6, err_msg=f)
    for f in ("scale", "g_var", "s_rel_sigma"):
        np.testing.assert_allclose(getattr(tr, f), getattr(jr, f), rtol=1e-6, err_msg=f)
