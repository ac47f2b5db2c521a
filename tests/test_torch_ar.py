"""Port parity of the AR overlay on the CPU.

- tests/test_ar.py's five checks on `vins_tpu_torch/ar/overlay.py`.
- Each function against `vins_tpu/ar/overlay.py` at 480×640 on random
  poses, cubes and landmark clouds from a numpy seed, through a distorted
  pinhole and a Kannala-Brandt camera: `cube_in_camera` to 1e-12 m,
  `rasterize_cube` with the same covered pixels and depths to 1e-12 m,
  `occlude`, `draw_axes` and `ArOverlay.render`: every pixel bit for bit
  (0 differing pixels, interior and edges, measured on every case here).
  The cube's blend is rounded once, as XLA's fused multiply-add rounds it;
  without that, ~30 % of the cube's pixels differ by one float32 ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vins_tpu.ar import overlay as jar
from vins_tpu.core.cameras import EquidistantCamera as JEquidistant
from vins_tpu.core.cameras import PinholeCamera as JPinhole
from vins_tpu_torch import convert
from vins_tpu_torch.ar.overlay import (ArOverlay, cube_in_camera, draw_axes, occlude,
                                       rasterize_cube)
from vins_tpu_torch.core.cameras import PinholeCamera

CAM = PinholeCamera.create(460.0, 460.0, 320.0, 240.0, device="cpu")
IMG = np.full((480, 640), 128.0, np.float32)
JCAMS = {
    "pinhole": JPinhole.create(460.0, 458.0, 322.0, 238.0, -0.28, 0.07, 1e-4, -2e-4),
    "kannala_brandt": JEquidistant.create(0.02, -0.01, 0.005, -0.001, 300.0, 301.0, 320.0, 240.0),
}


def _pose_identity():
    return torch.zeros(3, dtype=torch.float64), torch.tensor([1.0, 0.0, 0.0, 0.0],
                                                             dtype=torch.float64)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------ tests/test_ar.py on the port

def test_cube_renders_in_front():
    p, q = _pose_identity()
    corners = cube_in_camera(p, q, _t([0.0, 0.0, 3.0]), 0.8)
    out, zbuf = rasterize_cube(_t(IMG), corners, CAM)
    assert out.shape == (480, 640, 3)
    hit = np.isfinite(zbuf.numpy())
    assert hit.any()
    ys, xs = np.nonzero(hit)
    assert abs(xs.mean() - 320) < 3 and abs(ys.mean() - 240) < 3
    assert 100 < np.ptp(xs) < 160
    assert abs(zbuf.numpy()[hit].min() - 2.6) < 0.05
    base = np.broadcast_to(IMG[..., None], (480, 640, 3))
    changed = np.any(out.numpy() != base, -1)
    assert changed[hit].all() and not changed[~hit].any()


def test_cube_behind_camera_invisible():
    p, q = _pose_identity()
    corners = cube_in_camera(p, q, _t([0.0, 0.0, -3.0]), 0.8)
    _, zbuf = rasterize_cube(_t(IMG), corners, CAM)
    assert not np.isfinite(zbuf.numpy()).any()


def test_occlusion_hides_cube():
    p, q = _pose_identity()
    corners = cube_in_camera(p, q, _t([0.0, 0.0, 3.0]), 0.8)
    out, zbuf = rasterize_cube(_t(IMG), corners, CAM)
    occ = occlude(out, _t(IMG), zbuf, _t([[320.0, 240.0]]), _t([1.5]), _t([True]),
                  radius=10.0).numpy()
    assert np.allclose(occ[240, 320], 128.0)
    assert not np.allclose(occ[240, 280], 128.0)


def test_axes_drawn():
    p = _t([0.0, 0.0, -2.0])
    q = _t([1.0, 0.0, 0.0, 0.0])
    rgb = _t(IMG)[..., None].expand(480, 640, 3)
    out = draw_axes(rgb, p, q, CAM, torch.zeros(3)).numpy()
    assert (out != 128.0).any()
    reds = (out[..., 0] == 255) & (out[..., 1] == 0)
    assert reds.any()
    assert np.nonzero(reds)[1].max() > 320


def test_overlay_wrapper_end_to_end():
    ov = ArOverlay(camera=CAM, center_w=_t([0.0, 0.0, 3.0]), size=0.8)
    p, q = _pose_identity()
    out = ov.render(IMG, p, q, lm_w=_t([[0.0, 0.0, 1.5], [5.0, 5.0, 50.0]]),
                    lm_valid=_t([True, True])).numpy()
    assert out.shape == (480, 640, 3)
    assert np.allclose(out[240, 320], 128.0)


# ----------------------------------------------------- against vins_tpu

def scene(seed: int):
    """A camera pose near the origin looking down +z, a cube 2.5-4 m ahead,
    150 landmarks (ten in front of the cube, a fifth invalid, some behind
    the camera), an image."""
    rng = np.random.default_rng(seed)
    p = rng.normal(0.0, 0.3, 3)
    q = np.concatenate([[1.0], rng.normal(0.0, 0.1, 3)])
    q /= np.linalg.norm(q)
    center = np.array([rng.uniform(-0.5, 0.5), rng.uniform(-0.4, 0.4), rng.uniform(2.5, 4.0)])
    lm = np.concatenate([rng.uniform(-2.0, 2.0, (150, 2)), rng.uniform(-1.0, 6.0, (150, 1))], 1)
    # ten of them between the camera and the cube, to hide some of it
    lm[:10] = p + rng.uniform(0.3, 0.6, (10, 1)) * (center - p) + rng.normal(0.0, 0.15, (10, 3))
    valid = rng.uniform(size=150) > 0.2
    img = rng.uniform(0.0, 255.0, (480, 640)).astype(np.float32)
    return p, q, center, lm, valid, img


CASES = [(cam, seed) for cam in JCAMS for seed in (0, 1)]


@pytest.mark.parametrize("cam,seed", CASES)
def test_functions_against_jax(cam, seed):
    jcam = JCAMS[cam]
    tcam = convert.camera(jcam, "cpu")
    p, q, center, lm, valid, img = scene(seed)
    cj = jar.cube_in_camera(jnp.asarray(p), jnp.asarray(q), jnp.asarray(center), 0.8)
    ct = cube_in_camera(_t(p), _t(q), _t(center), 0.8)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-12)

    oj, zj = (np.asarray(a) for a in jar.rasterize_cube(jnp.asarray(img), cj, jcam))
    ot, zt = rasterize_cube(_t(img), _t(cj), tcam)
    ot, zt = ot.numpy(), zt.numpy()
    hit = np.isfinite(zj)
    assert hit.sum() > 1000
    np.testing.assert_array_equal(np.isfinite(zt), hit)
    np.testing.assert_allclose(zt[hit], zj[hit], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ot, oj)

    # the landmarks as the overlay hands them over: camera frame, projected
    lm_c = np.asarray(jar.lie.qrotate(jar.lie.qconj(jnp.asarray(q)), jnp.asarray(lm - p)))
    uv = np.asarray(jcam.project(jnp.asarray(lm_c)))
    ok = valid & (lm_c[:, 2] > 0.05)
    occ_j = np.asarray(jar.occlude(jnp.asarray(oj), jnp.asarray(img), jnp.asarray(zj),
                                   jnp.asarray(uv), jnp.asarray(lm_c[:, 2]), jnp.asarray(ok)))
    occ_t = occlude(_t(oj), _t(img), _t(zj), _t(uv), _t(lm_c[:, 2]), _t(ok)).numpy()
    assert np.any(occ_j != oj)  # some cube pixel is hidden
    np.testing.assert_array_equal(occ_t, occ_j)

    ax_j = np.asarray(jar.draw_axes(jnp.asarray(occ_j), jnp.asarray(p), jnp.asarray(q), jcam,
                                    jnp.zeros(3, jnp.float32)))
    ax_t = draw_axes(_t(occ_j), _t(p), _t(q), tcam, torch.zeros(3)).numpy()
    np.testing.assert_array_equal(ax_t, ax_j)


@pytest.mark.parametrize("cam,seed", CASES)
def test_render_against_jax(cam, seed):
    jcam = JCAMS[cam]
    p, q, center, lm, valid, img = scene(seed)
    want = np.asarray(jar.ArOverlay(camera=jcam, center_w=jnp.asarray(center), size=0.8).render(
        img, p, q, lm_w=jnp.asarray(lm), lm_valid=jnp.asarray(valid)))
    ov = ArOverlay(camera=convert.camera(jcam, "cpu"), center_w=_t(center), size=0.8)
    got = ov.render(img, p, q, lm_w=lm, lm_valid=valid)
    assert got.dtype == torch.float32 and got.shape == (480, 640, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ov.render(img, p, q).numpy(), np.asarray(
        jar.ArOverlay(camera=jcam, center_w=jnp.asarray(center), size=0.8).render(img, p, q)))


@pytest.mark.parametrize("radius", [12.0, 7.5, 0.5])
def test_occlude_disks_at_the_borders(radius):
    """The port's min-scatter over each disk's square against JAX's dense
    splat: landmarks on, near and far off every border, a fifth invalid,
    some at or behind the camera, on a cube that fills most of the image."""
    rng = np.random.default_rng(3)
    H, W = 480, 640
    zbuf = np.where(rng.uniform(size=(H, W)) < 0.8, rng.uniform(1.0, 4.0, (H, W)), np.inf)
    out = rng.uniform(0.0, 255.0, (H, W, 3)).astype(np.float32)
    img = rng.uniform(0.0, 255.0, (H, W)).astype(np.float32)
    L = 300
    uv = np.concatenate([rng.uniform(-30.0, [W + 30.0, H + 30.0], (L - 8, 2)),
                         [[-1e7, 5.0], [5.0, 3e8], [0.0, 0.0], [W - 1.0, H - 1.0],
                          [-radius, 10.0], [W - 1 + radius, 10.0], [100.5, -radius],
                          [np.nan, 3.0]]])
    depth = rng.uniform(-0.5, 5.0, L)
    valid = rng.uniform(size=L) > 0.2
    want = np.asarray(jar.occlude(jnp.asarray(out), jnp.asarray(img), jnp.asarray(zbuf),
                                  jnp.asarray(uv), jnp.asarray(depth), jnp.asarray(valid),
                                  radius=radius))
    got = occlude(_t(out), _t(img), _t(zbuf), _t(uv), _t(depth), _t(valid), radius=radius)
    assert np.any(want != out)
    np.testing.assert_array_equal(got.numpy(), want)
