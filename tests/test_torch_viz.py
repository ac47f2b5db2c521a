"""Port parity of the debug imagery and the report on the CPU.

- `vins_tpu_torch/utils/viz.py` against `vins_tpu/utils/viz.py`: each of
  the five functions on the cases of tests/test_viz.py, features on and
  past the image border, and an empty set; the port given tensors, JAX
  numpy arrays; the images bit for bit equal and the .pgm / .ppm / .ply
  files byte for byte.
- `Pipeline.print_statistics` of the port and of JAX on the same state,
  fresh and with a trajectory: every line but the tracer's timings equal.
- `Pipeline.debug_track_overlay`: None before the first frame; after a
  tracked frame, the JAX drawing of the tracker's state.
- `Pipeline._render_loop_match` on a hand-built keyframe pair with a stored
  match: an (H, 2W, 3) uint8 image whose line end points are within 1 px of
  JAX's (the two projections differ in the last float bits), and the same
  image.
"""
import types

import numpy as np
import pytest
import torch

from vins_tpu.config import VinsConfig as JConfig
from vins_tpu.pipeline import Pipeline as JPipeline
from vins_tpu.sim import proxy as jproxy
from vins_tpu.utils import viz as jviz
from vins_tpu_torch import convert
from vins_tpu_torch.pipeline import Pipeline as TPipeline
from vins_tpu_torch.sim import proxy as tproxy
from vins_tpu_torch.utils import viz as tviz

H, W = 480, 752


def overlay_cases():
    rng = np.random.default_rng(0)
    border = np.array([[0.0, 0.0], [3.0, 3.0], [2.9, 10.0], [W - 4.0, H - 4.0],
                       [W - 3.5, 100.0], [W + 5.0, -2.0], [-10.0, H + 1.0], [376.2, H - 3.01]])
    return {
        "test_viz": (np.full((60, 80), 100.0), np.array([[10.0, 10.0], [50.0, 30.0]]),
                     np.array([1, 40]), 20),
        "border": (rng.uniform(-20, 300, (H, W)), border, rng.integers(0, 45, len(border)), 20),
        "empty": (rng.uniform(0, 255, (H, W)), np.zeros((0, 2)), np.zeros(0, np.int64), 20),
        "many": (rng.uniform(0, 255, (H, W)).astype(np.float32),
                 rng.uniform(0, [W, H], (150, 2)), rng.integers(0, 60, 150), 10),
    }


@pytest.mark.parametrize("case", list(overlay_cases()))
def test_draw_track_overlay(case):
    img, uv, cnt, window = overlay_cases()[case]
    want = jviz.draw_track_overlay(img, uv, cnt, window=window)
    got = tviz.draw_track_overlay(torch.from_numpy(img), torch.from_numpy(uv),
                                  torch.from_numpy(cnt), window=window)
    assert got.dtype == np.uint8 and got.shape == img.shape + (3,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tviz.draw_track_overlay(img, uv, cnt, window=window), want)


def loop_cases():
    rng = np.random.default_rng(1)
    a, b = np.full((40, 60), 80.0), np.full((40, 60), 120.0)
    uc = np.array([[5.0, 5.0], [20.0, 30.0]])
    uo = np.array([[50.0, 6.0], [10.0, 28.0]])
    n = 40
    cur = np.concatenate([rng.uniform(0, [W, H], (n - 4, 2)),
                          [[0.0, 0.0], [W - 1.0, H - 1.0], [-5.0, 10.0], [1.5, H + 3.0]]])
    old = np.concatenate([rng.uniform(0, [W, H], (n - 4, 2)),
                          [[W - 0.5, 0.0], [0.0, H - 1.0], [W + 9.0, 3.0], [2.0, 2.0]]])
    big_a, big_b = rng.uniform(0, 255, (H, W)), rng.uniform(-9, 270, (H, W))
    return {
        "test_viz": (a, b, uc, uo, np.array([True, False])),
        "all_inliers": (a, b, uc, uo, None),
        "border": (big_a, big_b, cur, old, rng.random(n) > 0.3),
        "empty": (big_a, big_b, np.zeros((0, 2)), np.zeros((0, 2)), None),
        "unequal_heights": (np.full((30, 50), 10.0), np.full((40, 20), 200.0), uc, uo, None),
    }


@pytest.mark.parametrize("case", list(loop_cases()))
def test_draw_loop_match(case):
    a, b, uc, uo, inl = loop_cases()[case]
    want = jviz.draw_loop_match(a, b, uc, uo, inliers=inl)
    t = torch.from_numpy
    got = tviz.draw_loop_match(t(a), t(b), t(uc), t(uo),
                               inliers=None if inl is None else t(inl))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_files_byte_identical(tmp_path):
    rng = np.random.default_rng(2)
    gray = rng.uniform(-30, 290, (H, W))
    rgb = jviz.draw_loop_match(*loop_cases()["border"][:4])
    pts = rng.normal(size=(57, 3)) * 3
    for name, fn, x in (("g.pgm", "save_pgm", gray), ("m.ppm", "save_ppm", rgb),
                        ("c.ply", "write_ply", pts), ("e.ply", "write_ply", np.zeros((0, 3)))):
        getattr(jviz, fn)(str(tmp_path / f"jax_{name}"), x)
        getattr(tviz, fn)(str(tmp_path / f"port_{name}"), torch.from_numpy(np.asarray(x)))
        assert (tmp_path / f"port_{name}").read_bytes() == (tmp_path / f"jax_{name}").read_bytes()
    tviz.write_ply(str(tmp_path / "col.ply"), pts, color=(1, 2, 3))
    jviz.write_ply(str(tmp_path / "jcol.ply"), pts, color=(1, 2, 3))
    assert (tmp_path / "col.ply").read_text() == (tmp_path / "jcol.ply").read_text()


def cfg(**kw):
    return JConfig(**{"image_width": W, "image_height": H, "loop_closure": True,
                      "max_landmarks": 64, **kw})


@pytest.fixture(scope="module")
def pipes():
    jcfg = cfg(debug_image=True)
    jpipe = JPipeline(jcfg, jproxy.euroc_camera())
    tpipe = TPipeline(convert.vins_config(jcfg), tproxy.euroc_camera(device="cpu"),
                      device="cpu")
    return jpipe, tpipe


def report_lines(pipe):
    """The report without the tracer's timings (the last lines)."""
    n = len(pipe.tracer.stats.snapshot())
    lines = pipe.print_statistics().split("\n")
    return lines[:len(lines) - max(n, 1)]


def test_print_statistics(pipes):
    jpipe, tpipe = pipes
    fresh = report_lines(tpipe)
    assert fresh == report_lines(jpipe)
    assert [ln.split(":")[0] for ln in fresh] == ["position", "extrinsic tic", "pose graph"]
    rng = np.random.default_rng(3)
    traj = [(0.1 * k, rng.normal(size=3), np.array([1.0, 0, 0, 0])) for k in range(7)]
    for pipe in pipes:
        est = pipe.estimator
        est.p[est.W] = np.array([1.23456, -2.5, 0.0004])
        est.last_cost, est.failures, est.td = 12345.678, 2, 0.00321
        est.tic = np.array([0.051234, -0.02, 0.03])
        pipe.trajectory = list(traj)
    assert report_lines(tpipe) == report_lines(jpipe)
    assert report_lines(tpipe)[2].startswith("path length: ")
    with tpipe.tracer.span("frontend"):
        pass
    assert tpipe.print_statistics().split("\n")[-1].startswith("frontend ")


def test_debug_track_overlay():
    pipe = TPipeline(convert.vins_config(cfg(loop_closure=False)),
                     tproxy.euroc_camera(device="cpu"), device="cpu")
    assert pipe.debug_track_overlay() is None
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        inp = tproxy.proxy_inputs(duration=0.2, device="cpu")
        for k in range(2):
            pipe.process_image(inp.frames[k], float(inp.t[k]))
    finally:
        torch.set_num_threads(threads)
    tr = pipe.tracker
    m = tr.valid
    assert m.sum() > 50 and tr.track_cnt[m].max() >= 2  # tracked, not only detected
    want = jviz.draw_track_overlay(tr.prev_img.numpy(), tr.pts[m], tr.track_cnt[m],
                                   window=2 * pipe.cfg.window)
    got = pipe.debug_track_overlay()
    assert got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, want)


def test_render_loop_match(pipes, monkeypatch):
    rng = np.random.default_rng(4)
    n = 30
    ids = np.arange(100, 100 + n)
    uv = rng.uniform(0, [W, H], (n, 2))
    img_cur, img_old = rng.uniform(0, 255, (2, H, W)).astype(np.float32)
    match = {"kf_index": 1, "stamp": 2.0, "old_index": 0,
             "ids": np.concatenate([ids[rng.permutation(n)[:20]], [7]]),  # 7: not in the frame
             "pts_old": rng.uniform([-0.6, -0.4], [0.6, 0.4], (21, 2))}
    drawn = {}
    for key, mod in (("jax", jviz), ("port", tviz)):
        def record(a, b, uc, uo, inliers=None, key=key, draw=mod.draw_loop_match):
            drawn[key] = (np.asarray(uc), np.asarray(uo.cpu() if torch.is_tensor(uo) else uo))
            return draw(a, b, uc, uo, inliers)
        monkeypatch.setattr(mod, "draw_loop_match", record)
    out = {}
    for key, pipe, img in (("jax", pipes[0], np.asarray), ("port", pipes[1], torch.from_numpy)):
        kf = types.SimpleNamespace(image=img(img_cur), point_ids=ids, window_uv=uv)
        old = types.SimpleNamespace(image=img(img_old))
        monkeypatch.setattr(pipe, "pose_graph",
                            types.SimpleNamespace(last_match=match, keyframes=[old]))
        out[key] = pipe._render_loop_match(kf)
        assert pipe._render_loop_match(types.SimpleNamespace(image=None)) is None
    assert out["port"].shape == (H, 2 * W, 3) and out["port"].dtype == np.uint8
    np.testing.assert_array_equal(drawn["port"][0], drawn["jax"][0])
    assert np.abs(drawn["port"][1] - drawn["jax"][1]).max() < 1.0
    assert (drawn["port"][0][-1] == 0).all()
    np.testing.assert_array_equal(out["port"], out["jax"])
