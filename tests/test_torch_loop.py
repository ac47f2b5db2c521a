"""Port parity: the loop-closure programs of vins_tpu_torch.loop (brief,
retrieval, verify, relocalize, optimize4dof) against vins_tpu.loop on the
CPU, on the same inputs made with numpy.

FAST/BRIEF run on one rendered 752×480 frame of the JAX proxy's room with
σ = 2 pixel noise; the keyframe feature function on 120×160 crops of two
such frames; the rest on small synthetic sets.  RANSAC takes JAX's own
`jax.random.gumbel` draws.  Tolerances: `fast_score` 1e-4 absolute;
`fast_detect` the same points and flags in the same order (ties included);
`smooth_for_brief` 1e-5 relative; `brief_describe` ≥ 99.9 % of the bits
equal, each flipped bit a test whose two samples differ by < 1e-4 in the
JAX run; Hamming distances, matches, database scores and eviction exact;
PnP-RANSAC and the verification chain the same inliers and the pose to
1e-8; two-view triangulation 1e-9 relative; the relo refinement 1e-8; the
4-DoF solve 1e-9 against JAX's and against the port's own jacfwd form.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vins_tpu.core import lie as jlie
from vins_tpu.core.cameras import PinholeCamera as JPinhole
from vins_tpu.frontend.image import bilinear as jbilinear
from vins_tpu.loop import brief as jb
from vins_tpu.loop import optimize4dof as jo
from vins_tpu.loop import relocalize as jr
from vins_tpu.loop import retrieval as jret
from vins_tpu.loop import verify as jv
from vins_tpu_torch import convert
from vins_tpu_torch.core import nplie
from vins_tpu_torch.frontend.detect import top_k_stable
from vins_tpu_torch.loop import brief as tb
from vins_tpu_torch.loop import optimize4dof as to
from vins_tpu_torch.loop import pose_graph as tpg
from vins_tpu_torch.loop import relocalize as tr
from vins_tpu_torch.loop import retrieval as tret
from vins_tpu_torch.loop import verify as tv
from vins_tpu_torch.sim import proxy
from vins_tpu_torch.sim.render import RoomRenderer

torch.set_num_threads(4)
CROP = (slice(180, 300), slice(296, 456))  # 120×160
# vins_tpu's jitted fast_detect passes its traced threshold on as fast_score's
# static argument, which fails from the second trace in a process on; the
# same function jitted with the threshold static traces any number of times
# and leaves jb.fast_detect's own cache alone for the JAX package's tests
jfast_detect = jax.jit(jb.fast_detect.__wrapped__,
                       static_argnames=("max_pts", "cell", "threshold", "border"))


def T(a):
    return torch.from_numpy(np.array(a))


def N(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def render(p_b, q_b, seed):
    cam = proxy.euroc_camera(device="cpu")
    ren = RoomRenderer(cam, proxy.EUROC_H, proxy.EUROC_W, room=proxy.jax_proxy_room("cpu"),
                       tic=proxy.TIC, Ric=np.asarray(proxy.R_IC_FORWARD))
    img = ren.render_body(p_b, q_b)
    noise = np.random.default_rng(seed).normal(0.0, proxy.PIX_NOISE, img.shape)
    return np.clip(img + noise, 0.0, 255.0).astype(np.float32)


POSES = [(np.array([4.0, 0.0, 1.0]), nplie.R2q(nplie.ypr2R(np.array([90.0, 0.0, 0.0])))),
         (np.array([3.9, 0.35, 1.0]), nplie.R2q(nplie.ypr2R(np.array([95.0, 1.0, 0.0]))))]


@pytest.fixture(scope="module")
def frames():
    return [render(p, q, seed=i) for i, (p, q) in enumerate(POSES)]


@pytest.fixture(scope="module")
def fast(frames):
    img = frames[0]
    jp, jok = jfast_detect(jnp.asarray(img), max_pts=256, threshold=20.0)
    tp, tok = tb.fast_detect(T(img), max_pts=256, threshold=20.0)
    return img, (np.asarray(jp), np.asarray(jok)), (tp.numpy(), tok.numpy())


def test_fast_score_matches_jax(frames):
    js = np.asarray(jb.fast_score(jnp.asarray(frames[0])))
    ts = tb.fast_score(T(frames[0])).numpy()
    assert (js > 0).sum() > 1000
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-4)


def test_fast_detect_matches_jax(fast):
    _, (jp, jok), (tp, tok) = fast
    assert jok.sum() > 100
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tok, jok)


def test_top_k_ties_as_jax(frames):
    """FAST scores tie often; the top-k must pick and order ties as
    `jax.lax.top_k` (lower index first), which `torch.topk` does not
    promise.  Pinned on a vector and on a frame quantized to 16 gray
    levels, whose per-cell maxima tie at the top-k cutoff."""
    x = np.array([3, 5, 5, 1, 5, 0, 3, 5], np.float32)
    _, jidx = jax.lax.top_k(jnp.asarray(x), 5)
    _, tidx = top_k_stable(T(x), 5)
    assert np.asarray(jidx).tolist() == tidx.tolist() == [1, 2, 4, 7, 0]

    q = (np.round(frames[0] / 16.0) * 16.0).astype(np.float32)
    jp, jok = jfast_detect(jnp.asarray(q), max_pts=64, threshold=20.0)
    tp, tok = tb.fast_detect(T(q), max_pts=64, threshold=20.0)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    # the cutoff does fall inside a run of equal cell maxima
    s = np.asarray(jb.fast_score(jnp.asarray(q)))[28:452, 28:724]
    s = np.sort(s[: 26 * 16, : 43 * 16].reshape(26, 16, 43, 16).max(axis=(1, 3)).ravel())[::-1]
    assert s[63] == s[64] > 0


def test_smooth_for_brief_matches_jax(frames):
    js = np.asarray(jb.smooth_for_brief(jnp.asarray(frames[0])))
    ts = tb.smooth_for_brief(T(frames[0])).numpy()
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5 * np.abs(js).max())


def test_brief_describe_matches_jax(fast):
    img, (jp, _), _ = fast
    jsm = jb.smooth_for_brief(jnp.asarray(img))
    jd = np.asarray(jb.brief_describe(jsm, jnp.asarray(jp)))
    td = tb.brief_describe(tb.smooth_for_brief(T(img)), T(jp)).numpy()
    same = jd == td
    assert same.mean() >= 0.999, same.mean()
    pat = jnp.asarray(jb._PATTERN)
    a = np.asarray(jbilinear(jsm, jnp.asarray(jp)[:, None, :] + pat[None, :, 0:2]))
    b = np.asarray(jbilinear(jsm, jnp.asarray(jp)[:, None, :] + pat[None, :, 2:4]))
    assert np.all(np.abs(a - b)[~same] < 1e-4)
    np.testing.assert_array_equal(tb._PATTERN, jb._PATTERN)


def test_hamming_and_match_exact(fast):
    img, (jp, jok), _ = fast
    d = np.asarray(jb.brief_describe(jb.smooth_for_brief(jnp.asarray(img)), jnp.asarray(jp)))
    rng = np.random.default_rng(5)
    # a second set: the same corners with 0-40 bits flipped, shuffled
    perm = rng.permutation(len(d))
    flips = rng.random(d.shape) < rng.uniform(0, 40 / 256, (len(d), 1))
    d2 = np.where(flips, -d, d)[perm]
    v2 = jok[perm] & (rng.random(len(d)) < 0.9)
    np.testing.assert_array_equal(tb.hamming_matrix(T(d), T(d2)).numpy(),
                                  np.asarray(jb.hamming_matrix(jnp.asarray(d), jnp.asarray(d2))))
    ji, jm = jb.match_descriptors(jnp.asarray(d), jnp.asarray(jok), jnp.asarray(d2),
                                  jnp.asarray(v2))
    ti, tm = tb.match_descriptors(T(d), T(jok), T(d2), T(v2))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert np.asarray(jm).sum() > 50


def rand_desc(rng, n, P):
    return np.where(rng.random((n, P, 256)) < 0.5, 1.0, -1.0).astype(np.float32)


def test_keyframe_db_query_exact():
    """tests/test_loop.py:45's revisit and unrelated queries."""
    rng = np.random.default_rng(1)
    P = 64
    descs = rand_desc(rng, 60, P)
    valid = rng.random((60, P)) < 0.95
    jdb = jret.KeyframeDB(capacity=64, pts_per_kf=P)
    tdb = tret.KeyframeDB(capacity=64, pts_per_kf=P, device="cpu")
    for d, v in zip(descs, valid):
        jdb.add(jnp.asarray(d), jnp.asarray(v))
        tdb.add(T(d), T(v))
    noisy = np.where(rng.random((P, 256)) < 15 / 256, -descs[3], descs[3])
    for q in (noisy, rand_desc(rng, 1, P)[0]):
        for excl, newest in ((50, None), (5, 40)):
            ji, js = jdb.query(jnp.asarray(q), jnp.ones(P, bool), exclude_last=excl,
                               newest_kf=newest)
            ti, ts = tdb.query(T(q), torch.ones(P, dtype=torch.bool), exclude_last=excl,
                               newest_kf=newest)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(ts, js)
            assert tret.pick_loop_candidate(ti, ts) == jret.pick_loop_candidate(ji, js)
    ti, ts = tdb.query(T(noisy), torch.ones(P, dtype=torch.bool), exclude_last=50)
    assert ti[0] == 3 and ts[0] > 0.9


def test_keyframe_db_eviction_matches_jax():
    """tests/test_loop.py:362: past capacity the store halves; slot ids and
    query results follow."""
    rng = np.random.default_rng(5)
    cap, P, n_total = 32, 64, 52
    descs = rand_desc(rng, n_total, P).astype(np.int8)
    jdb = jret.KeyframeDB(capacity=cap, pts_per_kf=P)
    tdb = tret.KeyframeDB(capacity=cap, pts_per_kf=P, device="cpu")
    for i, d in enumerate(descs):
        jdb.add(jnp.asarray(d), jnp.ones(P, bool), kf_index=i)
        tdb.add(T(d), torch.ones(P, dtype=torch.bool), kf_index=i)
    assert (tdb.count, tdb.n_evicted) == (jdb.count, jdb.n_evicted) and tdb.n_evicted > 0
    np.testing.assert_array_equal(tdb.kf_index, jdb.kf_index)
    n = tdb.count
    np.testing.assert_array_equal(tdb.desc[:n].numpy(), np.asarray(jdb.desc)[:n])
    np.testing.assert_array_equal(tdb.valid.numpy(), np.asarray(jdb.valid))
    target = int(tdb.kf_index[2])
    ji, js = jdb.query(jnp.asarray(descs[target]), jnp.ones(P, bool), exclude_last=5,
                       newest_kf=n_total - 1)
    ti, ts = tdb.query(T(descs[target]), torch.ones(P, dtype=torch.bool), exclude_last=5,
                       newest_kf=n_total - 1)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)
    assert ti[0] == target


def pnp_problem(seed, N=80, outliers=0.3):
    """tests/test_loop.py:67's PnP set: points 4-12 m ahead, 30 % outliers."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4.0, 4.0, (N, 3)) + np.array([0, 0, 8.0])
    p_gt = np.array([0.4, -0.3, 0.2])
    q_gt = nplie.qnormalize(np.array([1.0, 0.025, -0.05, 0.075]))
    Pc = (X - p_gt) @ nplie.q2R(q_gt)
    x = Pc[:, :2] / Pc[:, 2:3]
    out = rng.random(N) < outliers
    x = np.where(out[:, None], x + rng.normal(0, 0.2, x.shape), x)
    valid = rng.random(N) < 0.95
    return X, x, valid, p_gt, q_gt


def test_pnp_ransac_matches_jax():
    X, x, valid, p_gt, _ = pnp_problem(2)
    key = jax.random.PRNGKey(3)
    p0, q0 = np.zeros(3), np.array([1.0, 0, 0, 0])
    jres = jv.pnp_ransac(jnp.asarray(X), jnp.asarray(x), jnp.asarray(valid), jnp.asarray(p0),
                         jnp.asarray(q0), key, min_inliers=25)
    g = np.asarray(jax.random.gumbel(key, (128, len(X)), jnp.float32))
    tres = tv.pnp_ransac(T(X), T(x), T(valid), T(p0), T(q0), T(g), min_inliers=25)
    np.testing.assert_array_equal(tres.inliers.numpy(), np.asarray(jres.inliers))
    assert int(tres.n_inliers) == int(jres.n_inliers) and bool(tres.ok) == bool(jres.ok)
    np.testing.assert_allclose(tres.p.numpy(), np.asarray(jres.p), rtol=0, atol=1e-8)
    np.testing.assert_allclose(tres.q.numpy(), np.asarray(jres.q), rtol=0, atol=1e-8)
    assert bool(tres.ok) and np.linalg.norm(tres.p.numpy() - p_gt) < 1e-6


def test_triangulate_two_view_matches_jax():
    rng = np.random.default_rng(4)
    P = 200
    Xw = rng.uniform(-3, 3, (P, 3)) + np.array([0, 0, 6.0])
    p0, p1 = np.zeros(3), np.array([0.4, 0.05, -0.1])
    R0 = np.eye(3)
    R1 = nplie.ypr2R(np.array([4.0, -2.0, 1.0]))

    def obs(p, R):
        Pc = (Xw - p) @ R
        return Pc[:, :2] / Pc[:, 2:3] + rng.normal(0, 1.5 / 460, (P, 2))

    x0, x1 = obs(p0, R0), obs(p1, R1)
    x1[:20] += 0.05  # mismatches, gated by reprojection
    valid = rng.random(P) < 0.9
    args = (p0, R0, x0, p1, R1, x1, valid)
    jX, jok = jv.triangulate_two_view(*[jnp.asarray(a) for a in args])
    tX, tok = tv.triangulate_two_view(*[T(a) for a in args])
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert 100 < tok.sum() < P
    jX = np.asarray(jX)
    assert np.all(np.abs(tX.numpy() - jX) <= 1e-9 * np.abs(jX).max(-1, keepdims=True))


def test_verify_connection_matches_jax():
    """The whole findConnection chain: 160 old corners, the current
    keyframe's corners = 120 of them (shuffled, bits flipped, 3D from the
    true points, 25 % wrong depths) + 40 others."""
    rng = np.random.default_rng(8)
    n_old, P = 160, 160
    Xw = rng.uniform(-3, 3, (n_old, 3)) + np.array([0.0, 0.0, 7.0])
    qic, tic = nplie.R2q(nplie.ypr2R(np.array([0.0, 0.0, -90.0]))), np.array([0.05, -0.02, 0.03])
    q_old_b = nplie.R2q(nplie.ypr2R(np.array([10.0, 2.0, 89.0])))
    p_old_b = np.array([0.3, 0.2, -0.1])
    R_old_c = nplie.q2R(nplie.qmul(q_old_b, qic))
    p_old_c = p_old_b + nplie.q2R(q_old_b) @ tic
    Pc = (Xw - p_old_c) @ R_old_c
    old_pts = (Pc[:, :2] / Pc[:, 2:3]).astype(np.float32)
    old_desc = rand_desc(rng, 1, n_old)[0]
    old_valid = rng.random(n_old) < 0.95

    sel = rng.permutation(n_old)[:120]
    q_desc = np.concatenate([np.where(rng.random((120, 256)) < 10 / 256, -old_desc[sel],
                                      old_desc[sel]), rand_desc(rng, 1, P - 120)[0]])
    X = np.concatenate([Xw[sel], rng.uniform(-3, 3, (P - 120, 3)) + [0, 0, 7.0]])
    X[:30] *= rng.uniform(0.7, 1.3, (30, 1))
    q_valid = rng.random(P) < 0.97
    q_cur = nplie.R2q(nplie.ypr2R(np.array([14.0, 2.0, 89.0])))
    p_cur = np.array([0.5, 0.0, 0.0])
    p_c0 = p_cur + nplie.q2R(q_cur) @ tic
    q_c0 = nplie.qmul(q_cur, qic)
    key = jax.random.PRNGKey(17)
    args = [q_desc, q_valid, X, old_desc, old_valid, old_pts, p_c0, q_c0, qic, tic, p_cur,
            q_cur]
    jout = jv.make_verify_connection(25)(*[jnp.asarray(a) for a in args], key)
    g = np.asarray(jax.random.gumbel(key, (128, P), jnp.float32))
    tout = tv.make_verify_connection(25)(*[T(a) for a in args], T(g))
    assert set(tout) == set(jout)
    for k in ("midx", "mok", "n_matches", "inliers", "n_inliers", "pnp_ok", "rel_ok", "ok"):
        np.testing.assert_array_equal(N(tout[k]), np.asarray(jout[k]), err_msg=k)
    for k in ("p_old_b", "q_old_b", "rel_t", "rel_yaw"):
        np.testing.assert_allclose(N(tout[k]), np.asarray(jout[k]), rtol=0, atol=1e-8,
                                   err_msg=k)
    assert bool(tout["ok"])
    assert np.linalg.norm(N(tout["p_old_b"]) - p_old_b) < 0.1


def test_keyframe_features_matches_jax(frames):
    """The keyframe feature program (vins_tpu/pipeline.py:84-107) on 120×160
    crops of the two frames, through a camera whose principal point follows
    the crop; the previous keyframe's outputs feed the current one."""
    intr = dict(proxy.EUROC_INTRINSICS)
    intr["cx"] -= CROP[1].start
    intr["cy"] -= CROP[0].start
    jcam = JPinhole.create(**intr)
    tcam = convert.camera(jcam, device="cpu")

    @jax.jit
    def jfeat(img, uv, prev_pts, prev_desc, prev_valid, prev_p, prev_R, p_cam, R_wc):
        sm = jb.smooth_for_brief(img)
        wdesc = jb.brief_describe(sm, uv)
        fpix, fok = jfast_detect(img, max_pts=64, threshold=20.0)
        fdesc = jb.brief_describe(sm, fpix)
        rays = jcam.lift(fpix)
        fpts = rays[..., :2] / rays[..., 2:3]
        pmidx, pmok = jb.match_descriptors(fdesc, fok, prev_desc, prev_valid)
        X3, okt = jv.triangulate_two_view(p_cam, R_wc, fpts, prev_p, prev_R,
                                          jnp.take(prev_pts, pmidx, axis=0), pmok)
        return wdesc, fpts, fdesc, fok, X3, okt

    Ric, tic = np.asarray(proxy.R_IC_FORWARD), np.asarray(proxy.TIC)
    cams = [(p + nplie.q2R(q) @ tic, nplie.q2R(q) @ Ric) for p, q in POSES]
    uv = np.random.default_rng(6).uniform([10, 10], [150, 110], (64, 2)).astype(np.float32)
    prev = [np.zeros((64, 2), np.float32), np.zeros((64, 256), np.float32),
            np.zeros(64, bool), np.zeros(3, np.float32), np.eye(3, dtype=np.float32)]
    for i, img in enumerate(frames):
        crop = np.ascontiguousarray(img[CROP])
        p_cam, R_wc = (a.astype(np.float32) for a in cams[i])
        args = [crop, uv] + prev + [p_cam, R_wc]
        jout = [np.asarray(a) for a in jfeat(*[jnp.asarray(a) for a in args])]
        tout = [a.numpy() for a in tv.keyframe_features(
            T(crop), T(uv), tcam, *[T(a) for a in args[2:]], max_fast=64)]
        for k in (0, 2):  # window and corner descriptors
            assert (tout[k] == jout[k]).mean() >= 0.999
        np.testing.assert_array_equal(tout[3], jout[3])
        np.testing.assert_allclose(tout[1], jout[1], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tout[5], jout[5])
        np.testing.assert_allclose(tout[4][jout[5]], jout[4][jout[5]], rtol=1e-4)
        prev = [jout[1], jout[2], jout[3], p_cam, R_wc]
    assert jout[3].sum() > 20 and jout[5].sum() > 5


def test_extract_keyframe_features_matches_jax(frames):
    """`pose_graph.extract_keyframe_features` and `describe_window_points`
    against vins_tpu/loop/pose_graph.py:91-107 (re-expressed with the
    static-threshold fast_detect) on a 120×160 crop."""
    intr = dict(proxy.EUROC_INTRINSICS)
    intr["cx"] -= CROP[1].start
    intr["cy"] -= CROP[0].start
    jcam = JPinhole.create(**intr)
    crop = np.ascontiguousarray(frames[0][CROP])
    im = jnp.asarray(crop)
    jsm = jb.smooth_for_brief(im)
    jpts, jok = jfast_detect(im, max_pts=64, threshold=20.0)
    rays = jcam.lift(jpts)
    jn = np.asarray(rays[..., :2] / rays[..., 2:3])
    jd = np.asarray(jb.brief_describe(jsm, jpts))
    tn, td, tok = tpg.extract_keyframe_features(T(crop), convert.camera(jcam, device="cpu"),
                                                max_fast=64)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tn.numpy(), jn, rtol=0, atol=1e-6)
    assert (td.numpy() == jd).mean() >= 0.999 and np.asarray(jok).sum() > 20
    uv = np.random.default_rng(7).uniform([10, 10], [150, 110], (32, 2)).astype(np.float32)
    jw = np.asarray(jb.brief_describe(jsm, jnp.asarray(uv)))
    tw = tpg.describe_window_points(T(crop), T(uv)).numpy()
    assert (tw == jw).mean() >= 0.999


def test_refine_relo_pose_matches_jax():
    X, x, valid, p_gt, q_gt = pnp_problem(11, N=120, outliers=0.2)
    p0 = p_gt + np.array([0.05, -0.03, 0.04])
    q0 = nplie.qmul(q_gt, nplie.deltaQ(np.array([0.02, -0.01, 0.015])))
    args = (X, x, valid, p0, q0)
    jres = jr.refine_relo_pose(*[jnp.asarray(a) for a in args])
    tres = tr.refine_relo_pose(*[T(a) for a in args])
    for f in ("p", "q", "cost"):
        np.testing.assert_allclose(N(getattr(tres, f)), np.asarray(getattr(jres, f)),
                                   rtol=1e-8, atol=1e-8, err_msg=f)
    assert int(tres.n_inliers) == int(jres.n_inliers) and bool(tres.ok) == bool(jres.ok)
    assert bool(tres.ok) and np.linalg.norm(tres.p.numpy() - p_gt) < 1e-4


def test_relative_pose_4dof_matches_jax():
    rng = np.random.default_rng(12)
    for _ in range(4):
        q_o = nplie.qnormalize(rng.normal(size=4))
        q_c = nplie.qnormalize(rng.normal(size=4))
        p_o, p_c = rng.normal(size=3), rng.normal(size=3)
        jt, jq, jy = jr.relative_pose_4dof(*[jnp.asarray(a) for a in (p_o, q_o, p_c, q_c)])
        tt, tq, ty = tr.relative_pose_4dof(p_o, q_o, p_c, q_c)
        np.testing.assert_allclose(tt, np.asarray(jt), atol=1e-12)
        np.testing.assert_allclose(tq, np.asarray(jq), atol=1e-12)
        assert abs(float(ty) - float(jy)) < 1e-9


def graph_arrays(seed=3, K=50, Kcap=64):
    """tests/test_loop.py:141's graph at a smaller size: nonzero pitch/roll,
    loop edges with large residuals (Huber active), one fixed anchor."""
    rng = np.random.default_rng(seed)
    t_vio = np.cumsum(rng.normal(0, 0.3, (K, 3)), axis=0)
    ypr = rng.normal(0, 15, (K, 3))

    def pad(a, fill=0.0):
        out = np.full((Kcap,) + a.shape[1:], fill, a.dtype)
        out[:K] = a
        return out

    loop_to, loop_t, loop_yaw = np.full(Kcap, -1, np.int32), np.zeros((Kcap, 3)), np.zeros(Kcap)
    for j, to_ in [(40, 3), (45, 10), (49, 0), (30, 20)]:
        loop_to[j], loop_t[j], loop_yaw[j] = to_, rng.normal(0, 1.0, 3), rng.normal(0, 5)
    fixed = np.zeros(Kcap, bool)
    fixed[[0, 7]] = True
    return dict(t_vio=pad(t_vio), ypr_vio=pad(ypr), yaw=pad(ypr[:, 0] + rng.normal(0, 2, K)),
                t=pad(t_vio + rng.normal(0, 0.1, (K, 3))), loop_to=loop_to, loop_t=loop_t,
                loop_yaw=loop_yaw, used=pad(np.ones(K, bool), False), fixed=fixed)


@pytest.fixture(scope="module")
def solved():
    arrs = graph_arrays()
    jg = jo.GraphArrays(**{k: jnp.asarray(v) for k, v in arrs.items()})
    tg = to.GraphArrays(**{k: T(v) for k, v in arrs.items()})
    return (arrs, jo.optimize_4dof(jg, iters=5), to.optimize_4dof(tg, iters=5),
            to.optimize_4dof(tg, iters=5, method="jacfwd"))


@pytest.mark.parametrize("against", ["jax_analytic", "port_jacfwd"])
def test_optimize_4dof(solved, against):
    arrs, ja, ta, tj = solved
    ref = ja if against == "jax_analytic" else tj
    np.testing.assert_allclose(ta.yaw.numpy(), N(ref.yaw), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ta.t.numpy(), N(ref.t), rtol=0, atol=1e-9)
    # the anchors and the unused slots stay exactly where they were
    held = arrs["fixed"] | ~arrs["used"]
    np.testing.assert_array_equal(ta.yaw.numpy()[held], arrs["yaw"][held])
    np.testing.assert_array_equal(ta.t.numpy()[held], arrs["t"][held])
    assert np.abs(ta.t.numpy() - arrs["t"]).max() > 0.05  # the solve moved the rest


def test_drift_from_matches_jax(solved):
    _, ja, ta, _ = solved
    for cur in (10, 49):
        for a, b in zip(jo.drift_from(ja, cur), to.drift_from(ta, cur)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-9)
