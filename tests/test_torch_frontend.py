"""Port parity: vins_tpu_torch front-end against vins_tpu on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its PyTorch counterpart.  The front-end computes in float32 on both sides,
so sums over windows and images differ by reduction order; each tolerance
below states its reason."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vins_tpu.core.cameras import PinholeCamera as JPinhole
from vins_tpu.frontend import detect as jdetect
from vins_tpu.frontend import fused as jfused
from vins_tpu.frontend import image as jimage
from vins_tpu.frontend import klt as jklt
from vins_tpu.init import relative_pose as jrel
from vins_tpu.sim import render as jrender
from vins_tpu_torch import convert
from vins_tpu_torch.frontend import detect as tdetect
from vins_tpu_torch.frontend import fused as tfused
from vins_tpu_torch.frontend import image as timage
from vins_tpu_torch.frontend import klt as tklt
from vins_tpu_torch.frontend.klt_cuda import lk_level
from vins_tpu_torch.init import relative_pose as trel

torch.set_num_threads(1)
H, W = 240, 320
WIN = 21
PAD = WIN // 2 + 2
# a distorted pinhole at 320×240 (EuRoC's radtan, focal scaled to the size)
CAM = dict(fx=230.0, fy=229.5, cx=161.0, cy=121.0, k1=-0.2917, k2=0.08228,
           p1=5.333e-05, p2=-1.578e-04)
FRONT = dict(max_cnt=80, min_dist=24, f_threshold=1.0, equalize=True, focal=460.0)


def smooth_texture(rng, h=H, w=W, scale=6):
    """Bilinear-upsampled coarse noise in [0, 255], float32."""
    coarse = rng.uniform(size=(h // scale + 2, w // scale + 2))
    y = np.arange(h) / scale
    x = np.arange(w) / scale
    y0, x0 = np.floor(y).astype(int), np.floor(x).astype(int)
    fy, fx = (y - y0)[:, None], (x - x0)[None, :]
    c = coarse
    img = (c[y0][:, x0] * (1 - fy) * (1 - fx) + c[y0][:, x0 + 1] * (1 - fy) * fx
           + c[y0 + 1][:, x0] * fy * (1 - fx) + c[y0 + 1][:, x0 + 1] * fy * fx)
    return (255.0 * img).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    img0 = smooth_texture(rng, scale=5)
    img1 = 0.9 * np.roll(img0, (1, 2), (0, 1)) + 0.1 * smooth_texture(rng, scale=3)
    return img0, img1.astype(np.float32)


def test_clahe_and_pyramid_match_jax(frames):
    img = frames[0] * 0.3 + 40.0  # low contrast
    # float32 cumsum and interpolation: a few ulps of 255
    np.testing.assert_allclose(np.asarray(timage.clahe(_t(img))),
                               np.asarray(jimage.clahe(jnp.asarray(img))), atol=2e-3)
    # the stencils sum in the reference's order: equal to f32 round-off
    for tp, jp in zip(timage.build_pyramid(_t(img), 3),
                      jimage.build_pyramid(jnp.asarray(img), 3)):
        np.testing.assert_allclose(np.asarray(tp), np.asarray(jp), rtol=1e-6, atol=1e-4)


def test_shi_tomasi_and_detect_grid_match_jax(frames):
    img = frames[0]
    tr = tdetect.shi_tomasi_response(_t(img))
    jr = jdetect.shi_tomasi_response(jnp.asarray(img))
    # f32 cancellation in tr − disc: 1e-6 of the image's peak response
    np.testing.assert_allclose(np.asarray(tr), np.asarray(jr), rtol=1e-5,
                               atol=1e-6 * float(np.abs(np.asarray(jr)).max()))
    rng = np.random.default_rng(1)
    existing = rng.uniform([0, 0], [W, H], (12, 2)).astype(np.float32)
    ev = rng.uniform(size=12) > 0.3
    # the same response into both: the selection itself is exact
    tp, tok = tdetect.detect_grid(_t(np.asarray(jr)), _t(existing), _t(ev), max_new=40, cell=30)
    jp, jok = jdetect.detect_grid(jr, jnp.asarray(existing), jnp.asarray(ev), max_new=40,
                                  cell=30)
    np.testing.assert_array_equal(np.asarray(tok), np.asarray(jok))
    np.testing.assert_array_equal(np.asarray(tp)[np.asarray(jok)],
                                  np.asarray(jp)[np.asarray(jok)])


@pytest.mark.parametrize("search", [32, 10])
def test_lk_level_matches_jax(frames, search):
    img0p = np.pad(frames[0], PAD, mode="edge")
    img1p = np.pad(frames[1], PAD, mode="edge")
    rng = np.random.default_rng(search)
    N = 48
    p0 = rng.uniform(1, [W - 2, H - 2], (N, 2)).astype(np.float32)
    g = (p0 + rng.uniform(-3, 3, (N, 2)) + [2.0, 1.0]).astype(np.float32)
    valid = rng.uniform(size=N) > 0.15
    jg, jok = jklt._lk_level(jnp.asarray(img0p), jnp.asarray(img1p), jnp.asarray(p0),
                             jnp.asarray(g), jnp.asarray(valid), WIN, 10, 0.01, 1e-4,
                             search=search)
    # on CPU tensors the kernel wrapper runs the plain version
    tg, tok = lk_level(_t(img0p), _t(img1p), _t(p0), _t(g), _t(valid), win=WIN,
                       search=search)
    np.testing.assert_array_equal(np.asarray(tok), np.asarray(jok))
    ok = np.asarray(jok)
    assert ok.sum() > N // 2
    # f32 window sums in another order, through 10 Gauss-Newton steps
    np.testing.assert_allclose(np.asarray(tg)[ok], np.asarray(jg)[ok], atol=1e-3)


def test_lk_pyramidal_recovers_shift_on_cpu():
    rng = np.random.default_rng(1)
    img0 = smooth_texture(rng, scale=6)
    dx, dy = 5.3, -3.7
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    img1 = timage.bilinear(_t(img0), torch.stack([_t(xx - dx), _t(yy - dy)], -1))
    pts = _t(np.array([[60.0, 60.0], [160.0, 80.0], [240.0, 180.0], [100.0, 200.0]],
                      np.float32))
    launches = lk_level.launches
    out, ok = tklt.lk_pyramidal(_t(img0), img1, pts, torch.ones(4, dtype=torch.bool))
    assert lk_level.launches == launches  # CPU tensors never reach the kernel
    assert bool(ok.all())
    assert np.abs(np.asarray(out) - (np.asarray(pts) + [dx, dy])).max() < 0.05


def _epipolar_set(rng, n=60, n_out=12):
    """Two views of random points, normalized coords, with outliers."""
    X = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(4, 8, (n, 1))], -1)
    ang = np.array([0.02, -0.05, 0.03])
    th = np.linalg.norm(ang)
    k = ang / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    t = np.array([0.3, 0.05, -0.1])
    X2 = X @ R.T + t
    x1 = X[:, :2] / X[:, 2:]
    x2 = X2[:, :2] / X2[:, 2:]
    x2 = x2 + rng.normal(0, 0.2 / 460, x2.shape)
    x2[:n_out] += rng.uniform(0.02, 0.05, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    return x1.astype(np.float32), x2.astype(np.float32)


def test_solve_relative_pose_matches_jax():
    rng = np.random.default_rng(3)
    x1, x2 = _epipolar_set(rng)
    valid = np.ones(len(x1), bool)
    valid[-5:] = False
    key = jax.random.PRNGKey(5)
    gum = np.asarray(jax.random.gumbel(key, (64, len(x1)), jnp.float32))
    thresh = 1.0 / 460.0
    jr = jrel.solve_relative_pose(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), key,
                                  thresh=thresh)
    tr = trel.solve_relative_pose(_t(x1), _t(x2), _t(valid), _t(gum), thresh=thresh)
    np.testing.assert_array_equal(np.asarray(tr.inliers), np.asarray(jr.inliers))
    assert int(tr.n_inliers) == int(jr.n_inliers) and bool(tr.ok) == bool(jr.ok)
    assert bool(jr.ok) and int(jr.n_inliers) >= 20
    # f32 8-point solves through inverse iteration: pose to ~1e-4
    np.testing.assert_allclose(np.asarray(tr.R), np.asarray(jr.R), atol=2e-4)
    np.testing.assert_allclose(np.asarray(tr.t), np.asarray(jr.t), atol=2e-3)


BLOB_TOL = [  # (name, size in units of M, atol); integer parts are exact
    ("un", 2, 1e-4),    # 1e-2 px over a 230 px focal
    ("vel", 2, 2e-3),   # un's tolerance over dt = 0.05 s
    ("pts", 2, 1e-2),   # px: LK sums in f32 in another order
    ("pub_mask", 1, 0), ("valid", 1, 0), ("track_cnt", 1, 0), ("ids", 1, 0),
]


def assert_blobs_match(tb, jb, M):
    tb, jb = np.asarray(tb, np.float32), np.asarray(jb, np.float32)
    assert tb.shape == jb.shape == (10 * M + 1,)
    tu, ju = tfused.unpack_front_blob(tb, M), jfused.unpack_front_blob(jb, M)
    valid = ju[4]
    for (name, _, atol), a, b in zip(BLOB_TOL, tu, ju):
        if atol:
            np.testing.assert_allclose(a[valid], b[valid], atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert tu[-1] == ju[-1]  # n_new


def test_front_step_blob_matches_jax():
    """Two rendered frames through make_front_step: detection on the first,
    LK + RANSAC + top-up on the second (started from JAX's own state)."""
    jcam = JPinhole.create(**CAM, dtype=jnp.float32)
    room = jrender.Room.make(jax.random.PRNGKey(7), k=48)
    jren = jrender.RoomRenderer(jcam, H, W, room=room, Ric=((0, 0, 1.0), (-1, 0, 0),
                                                             (0, -1, 0)))
    imgs = [np.asarray(jren.render_body(np.array([0.0, 0.05 * i, 1.0]),
                                        np.array([1.0, 0.0, 0.0, 0.0]))) for i in range(2)]
    M = FRONT["max_cnt"]
    jstep = jfused.make_front_step(jcam, **FRONT)
    tstep = tfused.make_front_step(convert.camera(jcam, device="cpu"), **FRONT, device="cpu")
    js = jfused.make_front_state(M, H, W)
    ts = tfused.make_front_state(M, H, W, device="cpu")
    key = jax.random.PRNGKey(11)
    gum = np.asarray(jax.random.gumbel(key, (64, M), jnp.float32))
    js1, jb1 = jstep(js, imgs[0], np.float32(0.0), key, np.int32(0), publish=True,
                     has_prev=False)
    ts1, tb1 = tstep(ts, imgs[0], 0.0, None, 0, publish=True, has_prev=False)
    assert_blobs_match(tb1, jb1, M)
    n_id = int(jfused.unpack_front_blob(np.asarray(jb1), M)[-1])
    assert n_id >= 40
    js2, jb2 = jstep(js1, imgs[1], np.float32(0.05), key, np.int32(n_id), publish=True,
                     has_prev=True)
    ts2, tb2 = tstep(convert.front_state(js1, device="cpu"), imgs[1], 0.05, _t(gum), n_id,
                     publish=True, has_prev=True)
    assert_blobs_match(tb2, jb2, M)
    assert tfused.unpack_front_blob(np.asarray(tb2), M)[3].sum() >= 30
