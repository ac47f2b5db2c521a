"""Port parity: vins_tpu_torch.core and config against vins_tpu on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its PyTorch counterpart.  Everything here runs in float64 on both sides
(the suite enables JAX's x64), so tolerances are a few hundred ulps: the
two libraries order reductions (norms, matmuls) differently."""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vins_tpu import config as jcfg
from vins_tpu.core import cameras as jcam
from vins_tpu.core import lie as jlie
from vins_tpu.core import linalg as jla
from vins_tpu_torch import config as tcfg
from vins_tpu_torch import convert
from vins_tpu_torch.core import cameras as tcam
from vins_tpu_torch.core import lie as tlie
from vins_tpu_torch.core import linalg as tla

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-10, atol=1e-12)  # f64, reduction order only


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(tout, jout, **tol):
    if isinstance(jout, (tuple, list)):
        for a, b in zip(tout, jout):
            _close(a, b, **tol)
        return
    np.testing.assert_allclose(np.asarray(tout), np.asarray(jout), **(tol or TOL))


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


LIE_CASES = {
    "qmul": lambda r: (_quats(r, 6), _quats(r, 6)),
    "qconj": lambda r: (_quats(r, 6),),
    "qnormalize": lambda r: (r.normal(size=(6, 4)),),
    "qrotate": lambda r: (_quats(r, 6), r.normal(size=(6, 3))),
    "deltaQ": lambda r: (0.1 * r.normal(size=(6, 3)),),
    "qexp": lambda r: (np.concatenate([r.normal(size=(5, 3)), np.zeros((1, 3))]),),
    "qlog": lambda r: (np.concatenate([_quats(r, 5), [[1.0, 0, 0, 0]]]),),
    "skew": lambda r: (r.normal(size=(6, 3)),),
    "Qleft": lambda r: (_quats(r, 6),),
    "Qright": lambda r: (_quats(r, 6),),
    "q2R": lambda r: (_quats(r, 6),),
    "R2q": lambda r: (np.asarray(jlie.q2R(jnp.asarray(_quats(r, 64)))),),
    "R2ypr": lambda r: (np.asarray(jlie.q2R(jnp.asarray(_quats(r, 6)))),),
    "ypr2R": lambda r: (r.uniform(-170, 170, size=(6, 3)),),
    "g2R": lambda r: (r.normal(size=(6, 3)) + np.array([0, 0, 9.8]),),
    "normalize_angle": lambda r: (r.uniform(-900, 900, size=(16,)),),
    "pose_boxplus": lambda r: (r.normal(size=(6, 3)), _quats(r, 6),
                               r.normal(size=(6, 3)), 0.1 * r.normal(size=(6, 3))),
}


@pytest.mark.parametrize("name", sorted(LIE_CASES))
def test_lie_matches_jax(name):
    args = LIE_CASES[name](np.random.default_rng(sorted(LIE_CASES).index(name)))
    jout = getattr(jlie, name)(*[jnp.asarray(a) for a in args])
    tout = getattr(tlie, name)(*[_t(a) for a in args])
    _close(tout, jout)


def _spd(rng, n, b=8):
    A = rng.normal(size=(b, n, n))
    return A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(n)


def test_linalg_matches_jax():
    rng = np.random.default_rng(0)
    M2 = rng.normal(size=(8, 2, 2))
    _close(tla.inv2x2(_t(M2)), jla.inv2x2(jnp.asarray(M2)))
    M3 = rng.normal(size=(8, 3, 3))
    _close(tla.inv3x3(_t(M3)), jla.inv3x3(jnp.asarray(M3)))
    H, b = _spd(rng, 6), rng.normal(size=(8, 6))
    _close(tla.spd_solve(_t(H), _t(b)), jax_vmap_spd_solve(H, b), rtol=1e-8, atol=1e-10)
    S = _spd(rng, 3)
    _close(tla.eigh3x3(_t(S)), jla.eigh3x3(jnp.asarray(S)), rtol=1e-8, atol=1e-9)
    _close(tla.svd3x3(_t(M3)), jla.svd3x3(jnp.asarray(M3)), rtol=1e-7, atol=1e-8)
    # an essential matrix has the repeated singular pair (1, 1, 0): its basis
    # within the pair's plane is arbitrary, so compare what callers use,
    # U·diag(1,1,0)·Vt and the null vectors
    U, _, Vt = np.linalg.svd(rng.normal(size=(8, 3, 3)))
    E = U @ np.diag([1.0, 1.0, 0.0]) @ Vt
    tU, ts, tVt = tla.svd3x3(_t(E))
    jU, js, jVt = jla.svd3x3(jnp.asarray(E))
    keep = np.array([1.0, 1.0, 0.0])
    _close((tU * _t(keep)) @ tVt, (jU * keep) @ jVt, rtol=1e-7, atol=1e-8)
    # s₃ = sqrt(max(λ₃, 0)) of a λ₃ at round-off level, so ~1e-8 absolute;
    # each null vector's sign is arbitrary (it follows the in-plane basis
    # and the sign of E·v₃ ≈ 0)
    _close(ts, js, rtol=1e-7, atol=1e-7)
    for tv, jv in ((tU[..., 2], jU[..., 2]), (tVt[..., 2, :], jVt[..., 2, :])):
        tv, jv = np.asarray(tv), np.asarray(jv)
        _close(tv * np.sign(np.sum(tv * jv, -1))[:, None], jv, rtol=1e-7, atol=1e-8)
    N9 = _spd(rng, 9)
    _close(tla.smallest_eigvec(_t(N9)), jla.smallest_eigvec(jnp.asarray(N9)),
           rtol=1e-8, atol=1e-10)


def jax_vmap_spd_solve(H, b):
    import jax

    return jax.vmap(jla.spd_solve)(jnp.asarray(H), jnp.asarray(b))


CAMERAS = {
    "pinhole": jcam.PinholeCamera.create(461.6, 460.3, 363.0, 248.1, -0.2917, 0.08228,
                                         5.333e-5, -1.578e-4, dtype=jnp.float64),
    "mei": jcam.MeiCamera.create(2.057, 1115.0, 1114.0, 367.2, 238.5, 0.07145, 0.5059,
                                 4.727e-5, -5.492e-4, dtype=jnp.float64),
    "equidistant": jcam.EquidistantCamera.create(-0.00574, 0.02878, -0.0401, 0.02008,
                                                 472.29, 470.84, 368.83, 232.24,
                                                 dtype=jnp.float64),
    "scaramuzza": jcam.ScaramuzzaCamera.create(
        [-180.0, 0.0, 1.5e-3, -1e-6, 2e-9], [280.0, 150.0, -10.0, 20.0, 5.0] + [0.0] * 15,
        1.0, 0.0, 0.0, 376.0, 240.0, dtype=jnp.float64),
}


@pytest.mark.parametrize("model", sorted(CAMERAS))
def test_camera_matches_jax(model):
    jc = CAMERAS[model]
    tc = convert.camera(jc, device="cpu")
    rng = np.random.default_rng(1)
    P = np.concatenate([rng.uniform(-0.4, 0.4, (32, 2)), rng.uniform(1.0, 4.0, (32, 1))], -1)
    _close(tc.project(_t(P)), jc.project(jnp.asarray(P)), rtol=1e-9, atol=1e-8)
    uv = rng.uniform([100.0, 80.0], [650.0, 400.0], (32, 2))
    _close(tc.lift(_t(uv)), jc.lift(jnp.asarray(uv)), rtol=1e-9, atol=1e-10)


CONFIGS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "config", "*.yaml")))


@pytest.mark.parametrize("name", CONFIGS)
def test_load_config_matches_jax(name):
    path = os.path.join(ROOT, "config", name)
    jc, tc = jcfg.load_config(path), tcfg.load_config(path)
    import dataclasses

    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    # the camera section builds the same model in both packages
    jm = jcam.camera_from_yaml(jc.camera, dtype=jnp.float64)
    tm = tcam.camera_from_yaml(tc.camera, dtype=torch.float64, device="cpu")
    assert type(tm).__name__ == type(jm).__name__
    _close(list(tm), list(jm))


def test_parse_cv_yaml_subset():
    text = """%YAML:1.0
# comment
a: 1   # trailing comment
b: 2.5e-3
s: "x # not a comment"
m: !!opencv-matrix
   rows: 2
   cols: 2
   dt: d
   data: [1, 2,
          3, 4]
n:
   k: -7
"""
    d = tcfg.parse_cv_yaml(text)
    assert d == {"a": 1, "b": 2.5e-3, "s": "x # not a comment",
                 "m": {"rows": 2, "cols": 2, "dt": "d", "data": [1, 2, 3, 4]},
                 "n": {"k": -7}}
