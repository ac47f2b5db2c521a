"""Port parity: vins_tpu_torch.estimator.step (the per-keyframe VIO step)
against vins_tpu's `make_vio_step` on the CPU.

The window is test_torch_solver's (6 frames, 96 landmark slots) with
perturbed states, a valid prior, half the active landmarks to triangulate
and a relo match on half of them (the inputs of test_torch_solver.py);
every `StepResult` field is compared on both `marg_old` branches with
`relo_on` 0 and 1 (the JAX step is jitted once).

Tolerances (float64): states and relo pose 1e-7 (eight damped Cholesky
solves on top of the 1e-9 assembly agreement, as `test_torch_solver`);
inverse depths 1e-6 relative; costs 1e-8 relative; the prior as JᵀJ and
Jᵀr0 to 1e-7 relative (QR may flip row signs).  The DLT null vector is
inverse iteration in the port (`core/linalg.dlt_null_vector`, 16 steps)
where JAX calls eigh: their depths agree to 1e-9 relative on this window."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_solver import F, JL, L, TL, rel, window_case
from vins_tpu.estimator import step as jstep
from vins_tpu.imu.preintegration import ImuNoise as JNoise
from vins_tpu.solver.gn import SolverOptions as JOpts
from vins_tpu_torch import convert
from vins_tpu_torch.estimator import step as tstep
from vins_tpu_torch.solver.gn import SolverOptions as TOpts

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    prob, s0, prior, relo = window_case()
    rng = np.random.default_rng(6)
    active = np.asarray(prob.obs.active)
    needs_tri = active & (rng.random(L) < 0.5)
    obs = prob.obs._replace(inv_depth=jnp.where(needs_tri, -1.0, prob.obs.inv_depth * 1.05))
    last_p = np.asarray(prob.state_true.p[F - 1]) + 0.05
    args = (s0, prob.raw_dt, prob.raw_acc, prob.raw_gyr, prob.raw_mask, obs,
            jnp.asarray(needs_tri), prior, prob.gravity)
    noise = JNoise()
    jfn = jstep.make_vio_step(JL, noise, JOpts(iters=6), with_relo=True, jit=True)
    tfn = tstep.make_vio_step(TL, convert.imu_noise(noise), TOpts(iters=6), with_relo=True)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    targs = (convert.window_state(s0, "cpu"), t(prob.raw_dt), t(prob.raw_acc),
             t(prob.raw_gyr), t(prob.raw_mask), convert.feature_obs(obs, "cpu"), t(needs_tri),
             convert.prior(prior, "cpu"), t(prob.gravity))
    return dict(args=args, targs=targs, relo=relo, last_p=last_p, jfn=jfn, tfn=tfn,
                active=active, obs=obs, prob=prob, s0=s0)


@pytest.mark.parametrize("relo_on", [0.0, 1.0])
@pytest.mark.parametrize("marg_old", [False, True])
def test_vio_step_matches_jax(case, marg_old, relo_on):
    c = case
    jr = c["jfn"](*c["args"], jnp.asarray(marg_old), jnp.asarray(c["last_p"]),
                  *[jnp.asarray(x) for x in c["relo"]], jnp.asarray(relo_on))
    tr = c["tfn"](*c["targs"], marg_old, torch.from_numpy(c["last_p"]),
                  *[torch.from_numpy(np.asarray(x)) for x in c["relo"]],
                  torch.tensor(relo_on, dtype=torch.float64))
    for f in ("p", "q", "v", "ba", "bg", "tic", "qic", "td"):
        np.testing.assert_allclose(getattr(tr.state, f).numpy(), np.asarray(getattr(jr.state, f)),
                                   rtol=0, atol=1e-7, err_msg=f)
    act = c["active"]
    np.testing.assert_allclose(tr.inv_depth.numpy()[act], np.asarray(jr.inv_depth)[act],
                               rtol=1e-6)
    np.testing.assert_array_equal(tr.inv_depth.numpy()[~act], np.asarray(jr.inv_depth)[~act])
    for f in ("cost0", "cost"):
        assert rel(getattr(tr, f).numpy(), getattr(jr, f)) < 1e-8, f
    for f in ("fail_imu", "fail_jump"):
        assert bool(getattr(tr, f)) == bool(getattr(jr, f)), f
    np.testing.assert_allclose(tr.relo_p.numpy(), np.asarray(jr.relo_p), atol=1e-7)
    np.testing.assert_allclose(tr.relo_q.numpy(), np.asarray(jr.relo_q), atol=1e-7)
    J, r = tr.prior.J.numpy(), tr.prior.r0.numpy()
    Jj, rj = np.asarray(jr.prior.J), np.asarray(jr.prior.r0)
    assert rel(J.T @ J, Jj.T @ Jj) < 1e-7
    assert rel(J.T @ r, Jj.T @ rj) < 1e-7
    for f in ("p", "q", "v", "ba", "bg", "tic", "qic", "td"):
        np.testing.assert_allclose(getattr(tr.prior.lin, f).numpy(),
                                   np.asarray(getattr(jr.prior.lin, f)), rtol=0, atol=1e-7)
    assert bool(tr.prior.valid) == bool(jr.prior.valid)
    # the step moved the window toward the truth and lowered the cost
    assert float(tr.cost) < float(tr.cost0)


def test_triangulate_depths_matches_eigh(case):
    """Inverse iteration (no host sync) against JAX's eigh on the true
    window: the DLT depth of every landmark seen twice or more."""
    st = case["prob"].state_true
    jd = np.asarray(jax.jit(jstep.triangulate_depths)(st, case["obs"]))
    td = tstep.triangulate_depths(convert.window_state(st, "cpu"),
                                  convert.feature_obs(case["obs"], "cpu")).numpy()
    seen = np.asarray(case["obs"].valid).sum(1) >= 2
    assert seen.sum() >= 10
    np.testing.assert_allclose(td[seen], jd[seen], rtol=1e-9)
