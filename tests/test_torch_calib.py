"""Port parity of the camera calibration on the CPU.

- `vins_tpu_torch/calib/intrinsics.py` against `vins_tpu/calib/
  intrinsics.py`: the four projections on random points and parameters;
  `homography_dlt`, `zhang_intrinsics` and `extrinsics_from_h` on rendered
  correspondences (≤ 1e-9 relative); `calibrate` for all four models on
  tests/test_calib.py's kinds of views (noise-free, and noisy for the
  pinhole): each intrinsic within 5e-8 of max(|value|, 1) (measured
  ≤ 7.6e-9), 2e-6 for SCARAMUZZA (measured 3.6e-7: its polynomial seed is
  a least-squares fit in θ⁰..θ⁴ that turns Zhang's 1e-12 into 4.8e-7
  before the first step), the rms within 1e-7 px, the poses within 1e-7,
  and the truth bounds of tests/test_calib.py on the port's result.
- `vins_tpu_torch/calib/chessboard.py` against `vins_tpu/calib/
  chessboard.py` on the axis-aligned board of tests/test_calib.py and a
  perspective board: the X-corner response (float32, ≤ 1e-5 of its
  maximum), the detected corners equal as a set with the same `ok`, the
  sub-pixel corners from the same start within 1e-3 px, and the ordered
  `find_chessboard` grid within 5e-4 px (measured ≤ 1.8e-4: float32 sums
  of 121 terms at ~300-px coordinates, in another order than XLA's).
- `calibrate_camera.main --device cpu` over PNGs in a temporary directory:
  its yaml's values equal JAX's `calibrate` on the same corners (5e-8 of
  max(|value|, 1)) and parse back through the port's cv::FileStorage
  reader.

Inputs come from numpy seeds; the JAX programs are jitted once.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vins_tpu.calib import chessboard as jcb
from vins_tpu.calib import intrinsics as jin
from vins_tpu_torch import calibrate_camera
from vins_tpu_torch.calib import chessboard as tcb
from vins_tpu_torch.calib import intrinsics as tin
from vins_tpu_torch.config import parse_cv_yaml
from vins_tpu_torch.core import nplie
from vins_tpu_torch.core.cameras import camera_from_yaml
from vins_tpu_torch.io.png import write_png_gray

ROWS, COLS, SQ = 6, 9, 0.1
N_VIEWS = 12  # every calibration here has 12 views: one JAX program per model
K_PERSP = np.array([[430.0, 0, 320.0], [0, 432.0, 240.0], [0, 0, 1]])

# tests/test_calib.py's models: the truth, the GN iterations and the rms bound
_SCARA_POLY = np.array([0.0, 320.0, 18.0, -6.0, 0.0])
_SCARA_POLY[0] = 320.0 * np.pi / 2 - 18.0 * (np.pi / 2) ** 2 - 6.0 * (np.pi / 2) ** 3
MODELS = {
    "PINHOLE": ([460.0, 458.0, 376.0, 240.0, -0.28, 0.07, 1e-4, -2e-4], 20, 0.05, 0.0),
    "PINHOLE_NOISY": ([460.0, 458.0, 376.0, 240.0, -0.28, 0.07, 0.0, 0.0], 20, 0.4, 0.2),
    "KANNALA_BRANDT": ([285.0, 286.0, 376.0, 240.0, 0.02, -0.01, 0.005, -0.001], 25, 0.1, 0.0),
    "MEI": ([0.9, 750.0, 748.0, 376.0, 240.0, -0.1, 0.02, 1e-4, -1e-4], 30, 0.2, 0.0),
    "SCARAMUZZA": (list(np.concatenate([[1.003, 0.002, -0.001, 376.0, 240.0], _SCARA_POLY])),
                   30, 0.2, 0.0),
}


def _project(model: str):
    return jin._PROJECT[model.replace("_NOISY", "")]


def views(model: str, n_views: int = 10, seed: int = 0):
    """tests/test_calib.py's synthetic correspondences from a numpy seed:
    board poses in front of the camera, projected through the JAX model."""
    params, _, _, jitter = MODELS[model]
    rng = np.random.default_rng(seed)
    obj = tcb.board_object_points(ROWS, COLS, SQ)
    Pb = np.concatenate([obj, np.zeros((len(obj), 1))], -1)
    imgs = []
    for _ in range(n_views):
        r = rng.uniform(-1.0, 1.0, 6)
        q = nplie.deltaQ(r[:3] * np.array([0.45, 0.45, 0.6]))
        t = np.array([-0.45 + 0.25 * r[3], -0.3 + 0.2 * r[4], 1.3 + 0.35 * r[5]])
        Pc = Pb @ nplie.q2R(q).T + t
        uv = np.asarray(_project(model)(jnp.asarray(params), jnp.asarray(Pc)))
        imgs.append(uv + jitter * rng.standard_normal(uv.shape))
    return (np.stack([obj] * n_views), np.stack(imgs), np.ones((n_views, len(obj)), bool))


def render_board(rows=ROWS, cols=COLS, square_px=40, off=(60, 40)):
    """tests/test_calib.py's axis-aligned board."""
    H = (rows + 1) * square_px + 2 * off[1]
    W = (cols + 1) * square_px + 2 * off[0]
    yy, xx = np.mgrid[:H, :W]
    sq_y = (yy - off[1]) // square_px
    sq_x = (xx - off[0]) // square_px
    inside = (sq_y >= 0) & (sq_y < rows + 1) & (sq_x >= 0) & (sq_x < cols + 1)
    return np.where(inside & (((sq_y + sq_x) % 2) == 0), 40.0, 220.0).astype(np.float32)


def render_perspective(K, R, t, rows=ROWS, cols=COLS, square=SQ, H=480, W=640):
    """tests/test_calib.py's inverse-warp render through a distortion-free
    pinhole."""
    Hi = np.linalg.inv(K @ np.column_stack([R[:, 0], R[:, 1], t]))
    yy, xx = np.mgrid[:H, :W]
    b = np.stack([xx + 0.0, yy + 0.0, np.ones_like(xx, float)], -1) @ Hi.T
    X, Y = b[..., 0] / b[..., 2], b[..., 1] / b[..., 2]
    sx = np.floor(X / square).astype(int)
    sy = np.floor(Y / square).astype(int)
    inside = (sx >= -1) & (sx < cols) & (sy >= -1) & (sy < rows) & (b[..., 2] != 0)
    return np.where(inside & (((sx + sy) % 2) == 0), 40.0, 220.0).astype(np.float32)


def perspective_images(n: int = 6, seed: int = 4):
    """Board views as tests/test_calib.py's full-pipeline test draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        R = nplie.q2R(nplie.deltaQ(rng.uniform(-0.35, 0.35, 3)))
        t = np.array([-0.45 + rng.uniform(-0.1, 0.1), -0.3 + rng.uniform(-0.07, 0.07),
                      1.4 + rng.uniform(-0.2, 0.2)])
        out.append(render_perspective(K_PERSP, R, t))
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


@pytest.mark.parametrize("model", ["PINHOLE", "KANNALA_BRANDT", "MEI", "SCARAMUZZA"])
def test_projection(model):
    rng = np.random.default_rng(1)
    params = np.array(MODELS[model][0]) * rng.uniform(0.9, 1.1, len(MODELS[model][0]))
    P = np.concatenate([rng.uniform(-1, 1, (200, 2)), rng.uniform(0.5, 4.0, (200, 1))], -1)
    want = np.asarray(jin._PROJECT[model](jnp.asarray(params), jnp.asarray(P)))
    got = tin._PROJECT[model](_t(params), _t(P)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)
    assert tin._N_INTR == jin._N_INTR and tin.SCARA_POLY_DEG == jin.SCARA_POLY_DEG


def test_homography_zhang_extrinsics():
    obj, img, valid = views("PINHOLE_NOISY", 8, seed=2)
    Hj = np.asarray(jax.jit(jax.vmap(jin.homography_dlt))(obj, img, valid))
    Ht = tin.homography_dlt(_t(obj), _t(img), _t(valid)).numpy()  # batched over views
    np.testing.assert_allclose(Ht, Hj, rtol=1e-9, atol=1e-9 * np.max(np.abs(Hj)))
    Kj = np.asarray(jin.zhang_intrinsics(jnp.asarray(Hj), jnp.ones(8, bool)))
    Kt = tin.zhang_intrinsics(_t(Hj), torch.ones(8, dtype=torch.bool)).numpy()
    assert _rel(Kt, Kj) < 1e-9, (Kt, Kj)
    Rj, tj = jax.jit(jax.vmap(jin.extrinsics_from_h, (0, None)))(Hj, Kj)
    Rt, tt = tin.extrinsics_from_h(_t(Hj), _t(Kj))  # batched over views
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-9)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("model", list(MODELS))
def test_calibrate(model):
    params, iters, rms_max, _ = MODELS[model]
    name = model.replace("_NOISY", "")
    obj, img, valid = views(model, N_VIEWS, seed=3)
    rj = jin.calibrate(jnp.asarray(obj), jnp.asarray(img), jnp.asarray(valid), model=name,
                       iters=iters)
    rt = tin.calibrate(_t(obj), _t(img), _t(valid), model=name, iters=iters)
    assert rt.intrinsics.dtype == torch.float64
    want = np.asarray(rj.intrinsics)
    scaled = np.abs(rt.intrinsics.numpy() - want) / np.maximum(np.abs(want), 1.0)
    assert np.max(scaled) < (2e-6 if name == "SCARAMUZZA" else 5e-8), scaled
    assert abs(float(rt.rms) - float(rj.rms)) < 1e-7
    np.testing.assert_allclose(rt.per_view_rms.numpy(), np.asarray(rj.per_view_rms), atol=1e-7)
    np.testing.assert_allclose(rt.rvecs.numpy(), np.asarray(rj.rvecs), atol=1e-7)
    np.testing.assert_allclose(rt.tvecs.numpy(), np.asarray(rj.tvecs), atol=1e-7)
    # tests/test_calib.py's rms bounds, and its center (or, for the wide
    # models, one projected point) against JAX's result on these views
    assert float(rt.rms) < rms_max
    P = np.array([[0.2, -0.15, 1.0]])
    np.testing.assert_allclose(tin._PROJECT[name](rt.intrinsics, _t(P)).numpy(),
                               np.asarray(jin._PROJECT[name](rj.intrinsics, jnp.asarray(P))),
                               atol=1e-4)
    if name in ("PINHOLE", "KANNALA_BRANDT"):
        np.testing.assert_allclose(rt.intrinsics[:4].numpy(), params[:4], rtol=0.01, atol=3.0)


@pytest.fixture(scope="module")
def boards():
    return {"axis": render_board(), "perspective": perspective_images(1)[0]}


@pytest.mark.parametrize("board", ["axis", "perspective"])
def test_corner_detection(boards, board):
    img = boards[board]
    rj = np.asarray(jcb.xcorner_response(jnp.asarray(img)))
    rt = tcb.xcorner_response(torch.from_numpy(img)).numpy()
    assert np.max(np.abs(rt - rj)) <= 1e-5 * np.max(np.abs(rj))
    n = ROWS * COLS + 16
    pj, okj = (np.asarray(a) for a in jcb.detect_corners(jnp.asarray(img), max_pts=n))
    pt, okt = (a.numpy() for a in tcb.detect_corners(torch.from_numpy(img), max_pts=n))
    np.testing.assert_array_equal(okt, okj)
    assert {tuple(p) for p in pt[okt]} == {tuple(p) for p in pj[okj]}
    sj = np.asarray(jcb.subpix_refine(jnp.asarray(img), jnp.asarray(pj)))
    st = tcb.subpix_refine(torch.from_numpy(img), torch.from_numpy(pj)).numpy()
    assert np.max(np.abs(st - sj)) < 1e-3


@pytest.mark.parametrize("board", ["axis", "perspective"])
def test_find_chessboard(boards, board):
    gj, okj = jcb.find_chessboard(boards[board], ROWS, COLS)
    gt, okt = tcb.find_chessboard(boards[board], ROWS, COLS, device="cpu")
    assert okj and okt and gt.shape == (ROWS * COLS, 2)
    assert np.max(np.abs(gt - gj)) < 5e-4


def test_calibrate_camera_main(tmp_path):
    for k, img in enumerate(perspective_images(N_VIEWS)):
        write_png_gray(str(tmp_path / f"view{k}.png"), np.round(img).astype(np.uint8))
    out_yaml = str(tmp_path / "cam.yaml")
    res, calib, corners = calibrate_camera.main(
        ["-i", str(tmp_path), "-w", str(COLS), "--rows", str(ROWS), "-s", str(SQ),
         "--model", "PINHOLE", "--iters", "20", "-o", out_yaml, "--device", "cpu"])
    assert res == {"views_used": len(corners), "rms_px": round(float(calib.rms), 4),
                   "output": out_yaml}
    assert len(corners) >= 4 and res["rms_px"] < 0.5
    obj = np.stack([tcb.board_object_points(ROWS, COLS, SQ)] * len(corners))
    rj = jin.calibrate(jnp.asarray(obj), jnp.asarray(corners), jnp.ones(obj.shape[:2], bool),
                       model="PINHOLE", iters=20)
    with open(out_yaml) as f:
        text = f.read()
    assert text.startswith("%YAML:1.0\n---\nmodel_type: PINHOLE\n")
    cfg = parse_cv_yaml(text)
    assert (cfg["image_width"], cfg["image_height"]) == (640, 480)
    p, d = cfg["projection_parameters"], cfg["distortion_parameters"]
    got = [p["fx"], p["fy"], p["cx"], p["cy"], d["k1"], d["k2"], d["p1"], d["p2"]]
    want = np.asarray(rj.intrinsics)
    assert np.max(np.abs(np.asarray(got) - want) / np.maximum(np.abs(want), 1.0)) < 5e-8
    cam = camera_from_yaml(cfg, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose([float(getattr(cam, f)) for f in cam._fields], got, rtol=0)
    # the JAX tool's truth bound for this renderer (tests/test_calib.py:151)
    np.testing.assert_allclose(got[:4], [430.0, 432.0, 320.0, 240.0], atol=6.0)
    assert os.listdir(tmp_path)
