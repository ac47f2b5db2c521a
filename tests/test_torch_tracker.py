"""Port parity: the FeatureTracker sequence and the room renderer of
vins_tpu_torch against vins_tpu on the CPU.

Both trackers see the same numpy frames; the port is handed the JAX
tracker's own RANSAC draws, so every id decision must agree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_frontend import CAM, FRONT, H, W, smooth_texture
from vins_tpu.core.cameras import PinholeCamera as JPinhole
from vins_tpu.frontend.tracker import FeatureTracker as JTracker
from vins_tpu.sim import render as jrender
from vins_tpu.sim.synthetic import Trajectory as JTrajectory
from vins_tpu_torch import convert
from vins_tpu_torch.frontend.tracker import N_HYP
from vins_tpu_torch.frontend.tracker import FeatureTracker as TTracker
from vins_tpu_torch.sim import render as trender
from vins_tpu_torch.sim.synthetic import Trajectory as TTrajectory

torch.set_num_threads(1)
SHIFTS = [(0.0, 0.0), (2.0, 1.0), (4.0, 2.0), (6.0, 3.0), (8.0, 4.0)]


def shifted(img, dx, dy):
    """Sample img at (x+dx, y+dy) bilinearly (contents move by (-dx, -dy))."""
    h, w = img.shape
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    x = np.clip(xx + dx, 0, w - 1.001)
    y = np.clip(yy + dy, 0, h - 1.001)
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = x - x0, y - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy
            ).astype(np.float32)


@pytest.fixture(scope="module")
def sequences():
    base = smooth_texture(np.random.default_rng(4), scale=5)
    frames = [shifted(base, -sx, -sy) for sx, sy in SHIFTS]
    jcam = JPinhole.create(**CAM, dtype=jnp.float32)
    jtr = JTracker(jcam, **FRONT)
    ttr = TTracker(convert.camera(jcam, device="cpu"), **FRONT, device="cpu")
    # the JAX tracker's own per-frame draws (tracker.py: split PRNGKey(42))
    key = jax.random.PRNGKey(42)
    jouts, touts = [], []
    for i, f in enumerate(frames):
        key, sub = jax.random.split(key)
        gum = np.asarray(jax.random.gumbel(sub, (N_HYP, FRONT["max_cnt"]), jnp.float32))
        jouts.append(jtr.read_image(f, 0.05 * i))
        touts.append(ttr.read_image(f, 0.05 * i, gumbel=gum))
    return jouts, touts


@pytest.mark.parametrize("frame", range(len(SHIFTS)))
def test_tracker_sequence_matches_jax(sequences, frame):
    jo, to = sequences[0][frame], sequences[1][frame]
    np.testing.assert_array_equal(to.ids, jo.ids)
    # f32 LK sums in another order: 1e-2 px, and that over the focal on
    # the normalized plane
    np.testing.assert_allclose(to.uv, jo.uv, atol=1e-2)
    np.testing.assert_allclose(to.pts, jo.pts, atol=1e-2 / CAM["fx"])
    np.testing.assert_allclose(to.vel, jo.vel, atol=1e-2 / CAM["fx"] / 0.05)
    if frame == len(SHIFTS) - 1:
        assert len(jo.ids) >= 20


def test_deferred_fetch_matches_read_image():
    """read_image_device + adopt_blob (the overlap-mode split) gives what
    read_image gives, frame by frame."""
    frames = [shifted(smooth_texture(np.random.default_rng(5), scale=5), -sx, -sy)
              for sx, sy in SHIFTS[:3]]
    cam = convert.camera(JPinhole.create(**CAM, dtype=jnp.float32), device="cpu")
    a = TTracker(cam, **FRONT, device="cpu")
    b = TTracker(cam, **FRONT, device="cpu")
    for i, f in enumerate(frames):
        publish = i != 1
        oa = a.read_image(f, 0.05 * i, publish=publish)
        handle = b.read_image_device(f, 0.05 * i, publish=publish)
        if not publish:
            assert oa is None and handle is None
            continue
        ob = b.adopt_blob(handle)
        for x, y in zip(oa, ob):
            np.testing.assert_array_equal(x, y)
    assert a.n_id == b.n_id > 0


def test_renderer_matches_jax():
    jcam = JPinhole.create(**CAM, dtype=jnp.float32)
    jroom = jrender.Room.make(jax.random.PRNGKey(3), k=48)
    Ric = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
    tic = (0.05, -0.02, 0.03)
    jren = jrender.RoomRenderer(jcam, H, W, room=jroom, tic=tic, Ric=np.asarray(Ric))
    tren = trender.RoomRenderer(convert.camera(jcam, device="cpu"), H, W,
                                room=convert.room(jroom, device="cpu"), tic=tic, Ric=Ric)
    jtraj = JTrajectory.circuit(radius=4.0, period=16.0, height=1.0)
    ttraj = TTrajectory.circuit(radius=4.0, period=16.0, height=1.0)
    t = 1.3
    p, q = np.asarray(jtraj.pos_fn(t)), np.asarray(jtraj.q(t))
    np.testing.assert_allclose(ttraj.pos_fn(t).numpy(), p, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ttraj.q(t).numpy(), q, rtol=1e-12, atol=1e-12)
    jimg = jren.render_body(p, q)
    timg = tren.render_body(p, q)
    assert timg.shape == (H, W) and np.isfinite(timg).all()
    # f32 cos of arguments up to ~2π·400 rad (a few 1e-4 rad of argument
    # round-off) times 215 gray levels; a face-boundary pixel may flip faces
    diff = np.abs(timg - jimg)
    assert np.mean(diff < 0.05) > 0.999, diff.max()
