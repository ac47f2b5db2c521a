"""Port parity: vins_tpu_torch.parallel.sharded (the landmark-sharded
window solve over torch.distributed) against the port's one-rank solve and
against vins_tpu.parallel.sharded on the CPU; the counterpart of
tests/test_parallel.py and tests/test_distributed.py.

The ranks are processes (`run_sharded.launch`: gloo on the CPU, one thread
each, a time limit of their own, all killed when one fails) that read the
problems from an .npz written here and write their results back; they
import neither JAX nor this module.  Four ranks on a seq = 2 × lm = 2 mesh
run the batched VIO step on JAX's window problems and perturbations of
keys 0-3 (tests/test_parallel.py's inputs, 6 frames × 64 landmarks,
float64), `marg_old` true for sequences 0 and 2 and false for 1 and 3, and
the sharded BA with the landmarks over all four ranks at 6 × 64 and at the
scaling benchmark's 11 × 4096 (the port's `build_window_problem`, seed 0); two ranks
reduce a landmark-sharded JᵀJ.  JAX's sharded functions run on four of
the conftest's eight CPU devices while the ranks run.

Bounds: against the port's one-rank step those of tests/test_parallel.py
(state and inverse depths 1e-8, cost 1e-9 relative, the prior as JᵀJ to
1e-5 of its largest entry + 1e-4 relative; the TSQR reorders the QR's
rows, so J itself differs by row signs and rotation); against JAX's sharded
step those of test_torch_step.py (1e-7, cost 1e-6 relative); the BA as
tests/test_parallel.py (cost 1e-8 relative, p 1e-8, points 1e-7)."""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vins_tpu.imu.preintegration import ImuNoise as JNoise
from vins_tpu.parallel import sharded as jsh
from vins_tpu.sim.window import build_window_problem, perturb_state
from vins_tpu.solver.gn import SolverOptions as JOpts
from vins_tpu.solver.problem import Layout as JLayout
from vins_tpu.solver.problem import Prior as JPrior
from vins_tpu_torch import convert, run_sharded
from vins_tpu_torch.estimator.step import make_vio_step
from vins_tpu_torch.imu.preintegration import ImuNoise
from vins_tpu_torch.parallel.sharded import Axis, Mesh, make_sharded_vio_step, mesh_shape
from vins_tpu_torch.solver.ba import BAState, ba_solve
from vins_tpu_torch.solver.gn import SolverOptions
from vins_tpu_torch.solver.problem import Layout

torch.set_num_threads(1)
DT = jnp.float64
FRAMES, LM, B, ITERS = 6, 64, 4, 4
MARG = np.array([True, False, True, False])
BA_SHAPES = {"6x64": (6, 64, 8), "11x4096": (11, 4096, 4)}  # frames, landmarks, iterations
RANK_LIMIT_S = 240.0


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def step_inputs(k: int):
    """tests/test_parallel.py's `_step_inputs` for key k."""
    key = jax.random.PRNGKey(k)
    prob = build_window_problem(frames=FRAMES, max_landmarks=LM, key=key, dtype=DT)
    state0 = perturb_state(prob.state_true, jax.random.fold_in(key, 1), pos_sigma=0.02,
                           rot_sigma=0.01, skip_first=1)
    return (state0, prob.raw_dt, prob.raw_acc, prob.raw_gyr, prob.raw_mask.astype(DT), prob.obs,
            jnp.zeros((LM,), bool), JPrior.empty(JLayout(FRAMES), DT), prob.gravity,
            jnp.asarray(MARG[k]), prob.state_true.p[-1]), prob


def ba_inputs(frames: int, L: int, prob=None):
    """The camera-frame BA of tests/test_parallel.py (JAX's window problem
    of key 0 at 6 × 64) or of the port's `build_window_problem` (seed 0) at other shapes."""
    if prob is None:
        return run_sharded.ba_inputs(frames, L, torch.float64, "cpu")
    from vins_tpu.core import lie
    from vins_tpu.solver.ba import BAState as JBA

    st = prob.state_true
    p_c = st.p + jax.vmap(lambda q: lie.qrotate(q, st.tic))(st.q)
    q_c = jax.vmap(lambda q: lie.qmul(q, st.qic))(st.q)
    key = jax.random.PRNGKey(5)
    state0 = JBA(p=p_c + 0.02 * jax.random.normal(key, p_c.shape, DT), q=q_c,
                 pts=prob.points + 0.05 * jax.random.normal(key, prob.points.shape, DT))
    valid = prob.obs.valid
    fix_pose = jnp.arange(frames) == 0
    return tuple(np.asarray(x) if not isinstance(x, tuple) else x for x in (
        state0, prob.obs.pt, valid, fix_pose, fix_pose | (jnp.arange(frames) == frames - 1),
        valid.sum(1) >= 2))


def to_torch(args):
    return tuple(convert.ba_state(a, "cpu") if isinstance(a, tuple) else torch.from_numpy(
        np.array(a)) for a in args)


def to_jax(args):
    from vins_tpu.solver.ba import BAState as JBA

    return tuple(JBA(*(jnp.asarray(x.numpy()) for x in a)) if isinstance(a, tuple)
                 else jnp.asarray(np.asarray(a)) for a in args)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    per = [step_inputs(k) for k in range(B)]
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[0] for p in per])
    batch = tuple(batch[:8]) + (per[0][0][8],) + tuple(batch[9:])  # gravity unbatched
    ba = {"6x64": ba_inputs(6, 64, per[0][1]),
          "11x4096": ba_inputs(11, 4096)}
    ba_t = {name: to_torch(a) for name, a in ba.items()}
    for name, (F, L, iters) in BA_SHAPES.items():
        run_sharded.save_inputs(str(tmp / f"ba_{name}.npz"), ba=ba_t[name], ba_iters=iters,
                                **({"step": jax.tree.map(np.asarray, batch), "iters": ITERS}
                                   if name == "6x64" else {}))
    rng = np.random.default_rng(0)
    jtj = (rng.normal(size=(64, 8)), rng.normal(size=(64,)))
    run_sharded.save_inputs(str(tmp / "jtj.npz"), jtj=jtj)

    def ranks(n, name, *mesh):
        out = tmp / f"out_{name}"
        out.mkdir()
        res = run_sharded.launch(n, ["--device", "cpu", *mesh, "--inputs",
                                     str(tmp / f"{name}.npz"), "--out", str(out)], RANK_LIMIT_S)
        for r, (rc, log) in enumerate(res):
            assert rc == 0, f"rank {r} of {name}: exit {rc}\n{log[-4000:]}"
        return [dict(np.load(out / f"rank{r}.npz")) for r in range(n)]

    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futures = {name: pool.submit(ranks, 4, f"ba_{name}", "--seq", "2", "--lm", "2")
                   for name in BA_SHAPES}
        futures["jtj"] = pool.submit(ranks, 2, "jtj", "--seq", "1", "--lm", "2")
        # JAX's sharded step and BA on a 2 × 2 mesh of the CPU devices
        mesh = jsh.make_mesh(jax.devices()[:4], seq=2, lm=2)
        jstep = jsh.make_sharded_vio_step(JLayout(FRAMES), JNoise(), JOpts(iters=ITERS), mesh)
        jout = jax.tree.map(np.asarray, jstep(*batch))
        jba = {}
        for name, (F, L, iters) in BA_SHAPES.items():
            st, cost = jsh.make_sharded_ba(mesh, iters=iters)(*to_jax(ba_t[name]))
            jba[name] = (jax.tree.map(np.asarray, st), float(cost))
        # the port's one-rank solves
        single = make_vio_step(Layout(FRAMES), ImuNoise(), SolverOptions(iters=ITERS))
        t = convert.window_state, convert.feature_obs, convert.prior
        refs = []
        for (args, _) in per:
            s, dt, acc, gyr, mask, obs, tri, prior, g, marg, last = args
            c = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
            refs.append(single(t[0](s, "cpu"), c(dt), c(acc), c(gyr), c(mask), t[1](obs, "cpu"),
                               c(tri), t[2](prior, "cpu"), c(g), bool(marg), c(last)))
        tba = {name: ba_solve(*ba_t[name], iters=BA_SHAPES[name][2]) for name in BA_SHAPES}
        out = {name: f.result() for name, f in futures.items()}
    return dict(ranks=out["6x64"], ba_ranks={n: out[n] for n in BA_SHAPES},
                jtj_ranks=out["jtj"], jtj=jtj, jax=jout, jba=jba, refs=refs, tba=tba)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_defaults_match_jax(n):
    jm = jsh.make_mesh(jax.devices()[:n])
    assert mesh_shape(n) == (jm.shape["seq"], jm.shape["lm"])
    assert mesh_shape(n, lm=1) == (n, 1) and mesh_shape(n, seq=1) == (1, n)
    with pytest.raises(ValueError):
        mesh_shape(n, seq=n + 1, lm=1)


def test_make_mesh_needs_a_process_group():
    from vins_tpu_torch.parallel.sharded import make_mesh

    with pytest.raises(RuntimeError):
        make_mesh()


def port_out(res, b, field):
    return res["ranks"][0][f"step/{field}"][b]


@pytest.mark.parametrize("b", range(B))
def test_sharded_step_matches_the_ports_single_step(results, b):
    ref = results["refs"][b]
    np.testing.assert_allclose(port_out(results, b, "state/p"), ref.state.p.numpy(), atol=1e-8)
    np.testing.assert_allclose(port_out(results, b, "inv_depth"), ref.inv_depth.numpy(),
                               atol=1e-8)
    np.testing.assert_allclose(port_out(results, b, "cost"), ref.cost.numpy(), rtol=1e-9)
    J = port_out(results, b, "prior/J")
    Hr, Hs = ref.prior.J.numpy().T @ ref.prior.J.numpy(), J.T @ J
    np.testing.assert_allclose(Hs, Hr, atol=1e-5 * np.abs(Hr).max(), rtol=1e-4)
    assert bool(port_out(results, b, "prior/valid")) == bool(ref.prior.valid)
    assert bool(port_out(results, b, "fail_imu")) == bool(ref.fail_imu)
    assert bool(port_out(results, b, "fail_jump")) == bool(ref.fail_jump)
    assert float(ref.cost) < float(ref.cost0)


@pytest.mark.parametrize("b", range(B))
def test_sharded_step_matches_jax_sharded_step(results, b):
    j = results["jax"]
    for f in ("p", "q", "v", "ba", "bg", "tic", "qic", "td"):
        np.testing.assert_allclose(port_out(results, b, f"state/{f}"),
                                   getattr(j.state, f)[b], rtol=0, atol=1e-7, err_msg=f)
    np.testing.assert_allclose(port_out(results, b, "inv_depth"), j.inv_depth[b], atol=1e-7)
    for f in ("cost0", "cost"):
        np.testing.assert_allclose(port_out(results, b, f), getattr(j, f)[b], rtol=1e-6)
    J, Jj = port_out(results, b, "prior/J"), j.prior.J[b]
    Hj = Jj.T @ Jj
    np.testing.assert_allclose(J.T @ J, Hj, atol=1e-5 * np.abs(Hj).max(), rtol=1e-4)
    if MARG[b]:
        assert np.abs(Hj).max() > 0  # a real prior was marginalized
    for f in ("p", "q", "v"):
        np.testing.assert_allclose(port_out(results, b, f"prior/lin/{f}"),
                                   getattr(j.prior.lin, f)[b], rtol=0, atol=1e-7)


def test_every_rank_returns_the_whole_batch(results):
    r0 = results["ranks"][0]
    for r in results["ranks"][1:]:
        for k, v in r0.items():
            if k.startswith("step/"):
                assert np.array_equal(r[k], v), k


def test_replicated_outputs_are_bitwise_equal_across_the_lm_ranks(results):
    """Ranks (s, 0) and (s, 1) solved sequence s's rows on different
    landmark blocks; every replicated output must be the same bits."""
    ranks = results["ranks"]
    rows = {}
    for r in ranks:
        rows.setdefault(int(r["seq_index"]), []).append(r)
    assert sorted(rows) == [0, 1] and all(len(v) == 2 for v in rows.values())
    for s, (a, b) in rows.items():
        assert np.array_equal(a["local_seqs"], b["local_seqs"])
        assert int(a["lm_index"]) != int(b["lm_index"])
        for k in a:
            if k.startswith("local") and k != "local_seqs" and "inv_depth" not in k:
                assert np.array_equal(a[k], b[k]), (s, k)
        assert not np.array_equal(a["local0/inv_depth"], b["local0/inv_depth"])


@pytest.mark.parametrize("ref", ["port", "jax"])
@pytest.mark.parametrize("shape", list(BA_SHAPES))
def test_sharded_ba_matches(results, shape, ref):
    r = results["ba_ranks"][shape][0]
    if ref == "port":
        st, cost = results["tba"][shape]
        st = BAState(*(x.numpy() for x in st))
    else:
        st, cost = results["jba"][shape]
    np.testing.assert_allclose(float(r["ba/cost"]), float(cost), rtol=1e-8)
    np.testing.assert_allclose(r["ba/state/p"], st.p, atol=1e-8)
    np.testing.assert_allclose(r["ba/state/pts"], st.pts, atol=1e-7)
    for other in results["ba_ranks"][shape][1:]:  # poses and cost the same bits on every rank
        for k in ("ba/cost", "ba/state/p", "ba/state/q", "ba/state/pts"):
            assert np.array_equal(other[k], r[k]), k


def test_two_process_psum(results):
    """The landmark-sharded JᵀJ reduction of tests/test_distributed.py,
    through the port's fused psum, against numpy."""
    J, r = results["jtj"]
    for res in results["jtj_ranks"]:
        np.testing.assert_allclose(res["jtj/H"], J.T @ J, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(res["jtj/b"], J.T @ r, rtol=1e-12, atol=1e-12)


def test_a_landmark_count_the_row_cannot_split_raises():
    """L % lm != 0 raises before any collective, so no process group is
    needed: rank 0 of a 1 × 2 mesh whose axes have no group."""
    mesh = Mesh(1, 2, 0, Axis(None, 2, 0), Axis(None, 2, 0))
    step = make_sharded_vio_step(Layout(3), ImuNoise(), SolverOptions(iters=1), mesh)
    with pytest.raises(ValueError):
        step(*run_sharded.step_inputs(1, 3, 3, torch.float64, "cpu"))
