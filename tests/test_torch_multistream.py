"""Port parity: the multi-stream pipeline of vins_tpu_torch
(`parallel/multistream.py`) and its batched parts against vins_tpu's
`parallel/multistream.py` on the CPU.

(a) The plain batched LK, pyramid, CLAHE, detection, relative pose and lift
    with S streams equal S single-stream calls exactly (each stream runs the
    same ops on its own data; the relative pose's R and t to 1e-6, through
    batched 3×3 products); the kernel wrapper never launches on CPU tensors
    and its launch raises.
(b) The batched front step (S = 2, 240×320 crops, a published frame, a
    track-only one and a tracked published one, the JAX trackers' draws)
    against `jax.jit(jax.vmap(tracker._step.__wrapped__))`, built as
    `vins_tpu/parallel/multistream.py:69-79` builds it, with
    test_torch_frontend's blob tolerances.
(c) The batched VIO step (S = 3: one slot marg_old true, one false, one zero
    blob outside the batch) against `jax.vmap(est._packed_step_raw)` on the
    same numpy-built blobs and priors (test_torch_solver's window), float64
    and float32.  Tolerances, float64 as test_torch_step.py: states 1e-7,
    inverse depths 1e-6 relative, costs 1e-8 relative, priors as JᵀJ and
    Jᵀr0 1e-7 relative.  Float32: the same quantities through the same
    damped Cholesky steps at float32's 1.2e-7 unit round-off, which the
    solve's conditioning amplifies (F32_TOL).  The zero slot's prior is
    the old one, bitwise.  The port's float32 step is as far from the
    float64 solution as JAX's float32 step, within 5 % (F32_GAP).
(d) `MultiPipeline` with S = 2 equals two single-stream `Pipeline`s on the
    same frames, IMU and draws (1.6 s of the proxy from t = 11 s; tracker
    seeds 43 and 44, with which each initializes at its first attempt, at
    t = 12.1 s, where the default 42 is still pending), to PIPE_TOL.  The JAX package's own two-stream run does not fit
    the test clock (the JAX multi-stream test did not finish in 170 s on
    this CPU); the whole-segment comparison with JAX is
    `tools/port_multistream_reference.py`.
(e) `run_multistream.main` on the CPU writes the JAX driver's keys."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_frontend import CAM, FRONT, H, W, assert_blobs_match, smooth_texture
from tests.test_torch_run_euroc import jax_proxy_config
from tests.test_torch_solver import F, L, window_case
from tests.test_torch_tracker import shifted
from vins_tpu.config import VinsConfig as JConfig
from vins_tpu.core.cameras import PinholeCamera as JPinhole
from vins_tpu.estimator.estimator import Estimator as JEstimator
from vins_tpu.frontend import fused as jfused
from vins_tpu.frontend.tracker import FeatureTracker as JTracker
from vins_tpu.sim.window import R_IC_FORWARD
from vins_tpu_torch import convert, run_multistream
from vins_tpu_torch.estimator.estimator import BatchedStep
from vins_tpu_torch.estimator.estimator import Estimator as TEstimator
from vins_tpu_torch.estimator.graph import stack_priors
from vins_tpu_torch.frontend import detect, fused, image, klt
from vins_tpu_torch.frontend.klt_cuda import lk_pyramid
from vins_tpu_torch.frontend.tracker import N_HYP
from vins_tpu_torch.frontend.tracker import FeatureTracker as TTracker
from vins_tpu_torch.init.relative_pose import solve_relative_pose
from vins_tpu_torch.parallel.multistream import MultiPipeline
from vins_tpu_torch.sim import proxy
from vins_tpu_torch.solver.problem import Prior

torch.set_num_threads(1)
S = 2
F32_TOL = dict(state=2e-3, inv_depth=2e-2, cost=2e-2, prior=2e-2)  # see the docstring
F32_GAP = 1.05  # port float32 vs float64 over JAX float32 vs float64 (1.006 measured)
PIPE_TOL = 1e-9  # m: batched float64 steps against single ones (vmap op order; 4e-11 measured)


def _t(a):
    return torch.as_tensor(np.array(a))


# --------------------------------------------------------------------- (a)

@pytest.fixture(scope="module")
def crops():
    """Two streams' frame pairs (120×160), each with its own texture and
    shift, and 40 features per stream, some at the borders, 15 % invalid."""
    out = []
    for s in range(S):
        rng = np.random.default_rng(20 + s)
        base = smooth_texture(rng, 120, 160, scale=5)
        img1 = shifted(base, -(1.5 + s), 0.7 - s)
        pts = rng.uniform(2, [158, 118], (40, 2)).astype(np.float32)
        pts[:4, 0] = rng.uniform(0.5, 12, 4)
        pts[4:8, 1] = rng.uniform(108, 118.5, 4)
        out.append((base, img1, pts, rng.uniform(size=40) > 0.15))
    return out


def test_batched_plain_lk_equals_single_calls(crops):
    img0 = _t(np.stack([c[0] for c in crops]))
    img1 = _t(np.stack([c[1] for c in crops]))
    pts = _t(np.stack([c[2] for c in crops]))
    valid = _t(np.stack([c[3] for c in crops]))
    launches = lk_pyramid.launches
    gb, okb = klt.lk_pyramidal(img0, img1, pts, valid)
    pyr0, pyr1 = image.build_pyramid(img0, 3), image.build_pyramid(img1, 3)
    gp, okp = lk_pyramid(pyr0, pyr1, pts, valid)
    assert gb.shape == (S, 40, 2) and okb.shape == (S, 40)
    for s in range(S):
        g1, ok1 = klt.lk_pyramidal(img0[s], img1[s], pts[s], valid[s])
        assert torch.equal(gb[s], g1) and torch.equal(okb[s], ok1)
        g2, ok2 = klt._lk_pyramid([p[s] for p in pyr0], [p[s] for p in pyr1], pts[s], valid[s])
        assert torch.equal(gp[s], g2) and torch.equal(okp[s], ok2)
        assert int(ok1.sum()) > 20
    assert lk_pyramid.launches == launches  # CPU tensors never reach the kernel
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        lk_pyramid.launch(pyr0, pyr1, pts, valid)


def test_batched_image_and_detect_equal_single_calls(crops):
    imgs = _t(np.stack([0.3 * c[0] + 40.0 for c in crops]))
    eq = image.clahe(imgs)
    resp = detect.shi_tomasi_response(eq)
    pts = _t(np.stack([c[2][:6] for c in crops]))  # 6 tracked features per stream
    valid = _t(np.stack([c[3][:6] for c in crops]))
    cand, okc = detect.detect_grid(resp, pts, valid, max_new=30, cell=20)
    pyr = image.build_pyramid(eq, 3)
    padded = image.edge_pad(eq, 12)
    for s in range(S):
        e1 = image.clahe(imgs[s])
        assert torch.equal(eq[s], e1)
        r1 = detect.shi_tomasi_response(e1)
        assert torch.equal(resp[s], r1)
        c1, ok1 = detect.detect_grid(r1, pts[s], valid[s], max_new=30, cell=20)
        assert torch.equal(okc[s], ok1) and torch.equal(cand[s], c1) and int(ok1.sum()) > 5
        for a, b in zip(pyr, image.build_pyramid(e1, 3)):
            assert torch.equal(a[s], b)
        assert torch.equal(padded[s], image.edge_pad(e1, 12))


def test_batched_relative_pose_and_lift_equal_single_calls():
    from tests.test_torch_frontend import _epipolar_set

    sets = [_epipolar_set(np.random.default_rng(30 + s)) for s in range(S)]
    x1, x2 = _t(np.stack([a for a, _ in sets])), _t(np.stack([b for _, b in sets]))
    valid = torch.ones(x1.shape[:2], dtype=torch.bool)
    valid[1, -7:] = False
    gum = _t(np.stack([np.asarray(jax.random.gumbel(jax.random.PRNGKey(40 + s), (N_HYP, 60),
                                                    jnp.float32)) for s in range(S)]))
    rb = solve_relative_pose(x1, x2, valid, gum, thresh=1.0 / 460.0)
    cam = convert.camera(JPinhole.create(**CAM, dtype=jnp.float32), device="cpu")
    uv = torch.rand((S, 30, 2), generator=torch.Generator().manual_seed(0)) * 200
    lb = cam.lift(uv)
    assert lb.shape == (S, 30, 3)
    for s in range(S):
        r1 = solve_relative_pose(x1[s], x2[s], valid[s], gum[s], thresh=1.0 / 460.0)
        for a, b in zip(rb[2:], r1[2:]):  # inliers, their count, ok: what the front step uses
            assert torch.equal(a[s], b)
        # R and t come through 3×3 products, batched (bmm) against single (mm),
        # which round differently: a few float32 ulps
        for a, b in zip(rb[:2], r1[:2]):
            torch.testing.assert_close(a[s], b, rtol=0, atol=1e-6)
        assert bool(r1.ok) and int(r1.n_inliers) >= 20
        assert torch.equal(lb[s], cam.lift(uv[s]))


# --------------------------------------------------------------------- (b)

@pytest.fixture(scope="module")
def front_runs():
    """Three ticks (publish, track-only, publish) of two streams through the
    JAX vmapped step and the port's batched step, each from the same state
    (the JAX state converted before every tick)."""
    M = FRONT["max_cnt"]
    frames = []
    for s in range(S):
        base = smooth_texture(np.random.default_rng(50 + s), scale=5)
        frames.append([shifted(base, -2.0 * k * (1 + s), -1.0 * k) for k in range(3)])
    jcam = JPinhole.create(**CAM, dtype=jnp.float32)
    jtr = JTracker(jcam, **FRONT)
    raw = jtr._step.__wrapped__
    programs = {}

    def jstep(publish, has_prev):
        if (publish, has_prev) not in programs:
            programs[publish, has_prev] = jax.jit(jax.vmap(
                lambda st, im, dt, k, n: raw(st, im, dt, k, n, publish=publish,
                                             has_prev=has_prev)))
        return programs[publish, has_prev]

    tcam = convert.camera(jcam, device="cpu")
    tstep = TTracker(tcam, **FRONT, device="cpu").batched_step()
    js = jax.tree.map(lambda *xs: jnp.stack(xs), *[jfused.make_front_state(M, H, W)] * S)
    keys = [jax.random.PRNGKey(60 + s) for s in range(S)]
    n_ids = np.zeros(S, np.int32)
    ticks = []
    for k, publish in enumerate((True, False, True)):
        subs = []
        for s in range(S):
            keys[s], sub = jax.random.split(keys[s])
            subs.append(sub)
        gum = np.stack([np.asarray(jax.random.gumbel(sub, (N_HYP, M), jnp.float32))
                        for sub in subs])
        dts = np.full(S, 0.05 if k else 0.0, np.float32)
        imgs = np.stack([frames[s][k] for s in range(S)])
        ts = fused.FrontState(*[_t(x) for x in js])
        js, jb = jstep(publish, k > 0)(js, jnp.asarray(imgs), jnp.asarray(dts), jnp.stack(subs),
                                       jnp.asarray(n_ids))
        ts2, tb = tstep(ts, _t(imgs), _t(dts), _t(gum), _t(n_ids), publish=publish,
                        has_prev=k > 0)
        ticks.append((np.asarray(jb), tb.numpy(), ts2, js))
        if publish:
            n_ids = n_ids + np.asarray(jb)[:, -1].view(np.int32)
    return ticks, M


@pytest.mark.parametrize("tick", [0, 1, 2])
def test_batched_front_step_matches_jax_vmap(front_runs, tick):
    ticks, M = front_runs
    jb, tb, ts, js = ticks[tick]
    assert tb.shape == jb.shape == (S, 10 * M + 1)
    for s in range(S):
        assert_blobs_match(tb[s], jb[s], M)
    if tick == 2:
        for s in range(S):
            assert fused.unpack_front_blob(tb[s], M)[3].sum() >= 20  # published tracks


# --------------------------------------------------------------------- (c)

def _estimators(dtype_j, dtype_t, N):
    cfg = JConfig(window=F - 1, max_landmarks=L, g_norm=9.81, extrinsic_R=R_IC_FORWARD,
                  extrinsic_t=(0.06, -0.01, 0.02))
    return (JEstimator(cfg, imu_buf_len=N, dtype=dtype_j),
            TEstimator(convert.vins_config(cfg), imu_buf_len=N, dtype=dtype_t, device="cpu"))


def _blob(est, prob, state, marg_old: bool, np_dtype):
    """A blob in the estimator's layout from the window problem."""
    o = prob.obs
    needs_tri = np.asarray(o.active) & (np.arange(L) % 3 == 0)
    inv_depth = np.where(needs_tri, -1.0, np.asarray(o.inv_depth) * 1.05)
    fields = dict(
        p=state.p, q=state.q, v=state.v, ba=state.ba, bg=state.bg, tic=state.tic,
        qic=state.qic, td=state.td, imu_dt=prob.raw_dt, imu_acc=prob.raw_acc,
        imu_gyr=prob.raw_gyr, imu_mask=prob.raw_mask, pt=o.pt, vel=o.vel, toff=o.toff,
        valid=o.valid, anchor=o.anchor, inv_depth=inv_depth, active=o.active,
        needs_tri=needs_tri, marg_old=float(marg_old),
        last_p=np.asarray(prob.state_true.p[F - 1]) + 0.05,
        relo_pq=np.array([0.0, 0, 0, 1, 0, 0, 0]), relo_pt=np.zeros((L, 2)),
        relo_valid=np.zeros(L), relo_on=0.0)
    return np.concatenate([np.ravel(np.asarray(fields[n], np_dtype)) for n, _ in est._blob_spec()])


@functools.cache
def _batched_steps(name):
    prob, s0, prior, _ = window_case()
    jdt, tdt, ndt = ((jnp.float64, torch.float64, np.float64) if name == "float64"
                     else (jnp.float32, torch.float32, np.float32))
    N = prob.raw_dt.shape[1]
    jest, test = _estimators(jdt, tdt, N)
    blobs = np.stack([_blob(test, prob, s0, True, ndt), _blob(test, prob, s0, False, ndt),
                      np.zeros(test._offs[-1], ndt)])
    jprior = jax.tree.map(lambda x: jnp.asarray(x, jdt) if x.dtype != bool else x, prior)
    jprior_b = jax.tree.map(lambda *xs: jnp.stack(xs), jprior, jprior, jprior)
    jres = jax.jit(jax.vmap(jest._packed_step_raw))(jnp.asarray(blobs), jprior_b)
    tprior = convert.prior(jprior, "cpu")
    bs = BatchedStep(test, 3)
    for s in range(3):
        bs.set_prior(s, tprior)
    old = stack_priors([tprior] * 3)
    tres = bs.fetch(bs.dispatch(blobs, np.array([True, True, False])))
    return name, jres, tres, bs.prior, old, test


@pytest.fixture(scope="module", params=["float64", "float32"])
def batched_steps(request):
    return _batched_steps(request.param)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("slot", [0, 1])
def test_batched_step_matches_jax_vmap(batched_steps, slot):
    name, jres, tres, prior_b, _, _ = batched_steps
    tol = (dict(state=1e-7, inv_depth=1e-6, cost=1e-8, prior=1e-7) if name == "float64"
           else F32_TOL)
    tr = tres[slot]
    for f in ("p", "q", "v", "ba", "bg"):
        np.testing.assert_allclose(getattr(tr.state, f), np.asarray(getattr(jres.state, f))[slot],
                                   rtol=0, atol=tol["state"], err_msg=f"{name} {f}")
    assert _rel(tr.inv_depth, np.asarray(jres.inv_depth)[slot]) < tol["inv_depth"]
    assert _rel(tr.cost, np.asarray(jres.cost)[slot]) < tol["cost"]
    assert bool(tr.fail_imu) == bool(jres.fail_imu[slot])
    J, r = prior_b.J[slot].double().numpy(), prior_b.r0[slot].double().numpy()
    Jj, rj = np.asarray(jres.prior.J[slot], float), np.asarray(jres.prior.r0[slot], float)
    assert _rel(J.T @ J, Jj.T @ Jj) < tol["prior"], (name, slot)
    assert _rel(J.T @ r, Jj.T @ rj) < tol["prior"], (name, slot)
    assert bool(prior_b.valid[slot]) == bool(jres.prior.valid[slot])


def test_zero_slot_keeps_its_prior(batched_steps):
    _, _, tres, prior_b, old, _ = batched_steps
    for a, b in zip((prior_b.J, prior_b.r0, *prior_b.lin, prior_b.valid),
                    (old.J, old.r0, *old.lin, old.valid)):
        assert torch.equal(a[2], b[2])
    assert not np.isfinite(tres[2].state.p).all()  # its garbage stays in its result


def test_batched_step_equals_single_steps(batched_steps):
    """Slot s of the batched step against `Estimator.packed_step` on the
    same blob and prior (the single-stream step with its Python-bool
    branch)."""
    name, _, tres, prior_b, old, test = batched_steps
    prob, s0, prior, _ = window_case()
    ndt = np.float64 if name == "float64" else np.float32
    for slot, marg in ((0, True), (1, False)):
        blob = torch.from_numpy(_blob(test, prob, s0, marg, ndt))
        one = Prior(J=old.J[slot], r0=old.r0[slot],
                    lin=type(old.lin)(*[x[slot] for x in old.lin]), valid=old.valid[slot])
        res = test.packed_step(blob, one, marg)
        ref = test._unpack_result(test._pack_result(res).numpy())
        # the same ops vmapped: batched and single products round apart, by
        # ~1e-12 m at float64; at float32 the damped solve's conditioning
        # makes their ~1e-7 relative rounding 3e-4 m (measured), F32_TOL's
        # state bound
        tol, ptol = (1e-9, 1e-9) if name == "float64" else (F32_TOL["state"], F32_TOL["prior"])
        for f in ("p", "q", "v", "ba", "bg"):
            np.testing.assert_allclose(getattr(tres[slot].state, f), getattr(ref.state, f),
                                       rtol=0, atol=tol, err_msg=f)
        # priors as JᵀJ and Jᵀr0: QR may flip row signs
        J, r = prior_b.J[slot].double().numpy(), prior_b.r0[slot].double().numpy()
        Jo, ro = res.prior.J.double().numpy(), res.prior.r0.double().numpy()
        assert _rel(J.T @ J, Jo.T @ Jo) < ptol and _rel(J.T @ r, Jo.T @ ro) < ptol, (name, slot)


@pytest.mark.parametrize("slot", [0, 1])
def test_float32_step_is_as_close_to_float64_as_jax(slot):
    """The float32 step's distance from the float64 solution (JAX's, on the
    same blob and prior) is JAX's float32 distance, within F32_GAP.  One
    float32 solve of this window lands 7.6 cm and 0.18 m/s away from the
    float64 one in both packages (the damped normal equations' conditioning
    at float32), so a port whose float32 step were less precise than JAX's
    would fail here, where a whole run's ATE only samples it."""
    _, j64, _, _, _, _ = _batched_steps("float64")
    _, j32, t32, _, _, _ = _batched_steps("float32")
    for f in ("p", "q", "v"):
        ref = np.asarray(getattr(j64.state, f), float)[slot]
        gap_jax = np.abs(np.asarray(getattr(j32.state, f), float)[slot] - ref).max()
        gap_port = np.abs(np.asarray(getattr(t32[slot].state, f), float) - ref).max()
        assert gap_port <= F32_GAP * gap_jax, (f, gap_port, gap_jax)


# --------------------------------------------------------------------- (d)

SECONDS, T0 = 1.6, 11.0


@pytest.fixture(scope="module")
def pipeline_runs():
    threads = torch.get_num_threads()
    torch.set_num_threads(4)  # 16 rendered 752×480 frames and three pipelines on them
    try:
        yield _pipeline_runs()
    finally:
        torch.set_num_threads(threads)


def _pipeline_runs():
    inp = proxy.proxy_inputs(duration=SECONDS, t0=T0, device="cpu")

    def make(s):
        pipe = proxy.make_pipeline(device="cpu", loop_closure=False)
        pipe.tracker._gen.manual_seed(43 + s)
        return pipe

    singles, published = [], []
    for s in range(S):
        pipe = make(s)
        for fi, t in enumerate(inp.t):
            if fi > 0:
                for ti, a, w in zip(inp.imu_t[fi - 1], inp.acc[fi - 1], inp.gyr[fi - 1]):
                    pipe.process_imu(float(ti), a, w)
            ev = pipe.process_image(inp.frames[fi], float(t))
            if s == 0:
                published.append(ev["published"])
        singles.append(pipe)
    mp = MultiPipeline(make, S, loop_closure=False)
    imgs = [torch.stack([f] * S) for f in inp.frames]
    for fi, t in enumerate(inp.t):
        if fi > 0:
            for ti, a, w in zip(inp.imu_t[fi - 1], inp.acc[fi - 1], inp.gyr[fi - 1]):
                for s in range(S):
                    mp.process_imu(s, float(ti), a, w)
        mp.process_images(imgs[fi], float(t), publish=published[fi])
    mp.finish()
    return singles, mp


def test_multipipeline_equals_single_pipelines(pipeline_runs):
    singles, mp = pipeline_runs
    assert mp.est_step.dispatches >= 4  # one batched step per VIO tick
    for s in range(S):
        one, multi = singles[s].estimator, mp.pipes[s].estimator
        assert one.solver_flag == multi.solver_flag == 1 and one.failures == multi.failures == 0
        ts = {t: (p, q) for t, p, q in singles[s].trajectory}
        assert len(mp.pipes[s].trajectory) >= len(ts) - 1 >= 4  # all but the init frame
        for t, p, q in mp.pipes[s].trajectory:
            np.testing.assert_allclose(p, ts[t][0], rtol=0, atol=PIPE_TOL)
            np.testing.assert_allclose(q, ts[t][1], rtol=0, atol=PIPE_TOL)
    # the two streams' own draws give two different track sets
    assert not np.array_equal(mp.pipes[0].trajectory[-1][1], mp.pipes[1].trajectory[-1][1])


# --------------------------------------------------------------------- (e)

def test_run_multistream_main_writes_the_keys(tmp_path):
    out = tmp_path / "ms.json"
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        res = run_multistream.main(["--device", "cpu", "--streams", "2", "--duration", "0.3",
                                    "--no-loop", "--out", str(out)])
    finally:
        torch.set_num_threads(threads)
    keys = ["streams", "aggregate_fps", "per_stream_fps", "ate_per_stream_m",
            "loops_per_stream", "reboots", "frames_timed"]
    assert list(res) == keys and list(json.loads(out.read_text())) == keys
    assert res["streams"] == 2 and len(res["ate_per_stream_m"]) == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_make_pipeline_options_match_jax(dtype):
    """`make_pipeline`'s dtype argument, as JAX's, with JAX's noise densities."""
    pipe = proxy.make_pipeline(device="cpu", loop_closure=False, dtype=dtype)
    assert pipe.estimator.dtype == dtype and pipe.estimator.prior.J.dtype == dtype
    jcfg = jax_proxy_config()
    assert (pipe.cfg.acc_n, pipe.cfg.gyr_n) == (jcfg.acc_n, jcfg.gyr_n)
