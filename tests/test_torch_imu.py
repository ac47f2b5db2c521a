"""Port parity: vins_tpu_torch.imu.preintegration against vins_tpu on the CPU.

The same seeded numpy IMU samples (three intervals, the last two with
masked tails) go through the JAX functions and the port's, in float64.
Tolerances: the serial recurrence against itself agrees to reduction order
(1e-12 relative); the log-depth scans associate the N products in another
tree than JAX's `associative_scan` and the serial loop, so they agree to
1e-9 relative on J and P (entries span ~10 orders of magnitude) and 1e-12
on the deltas."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vins_tpu.imu import preintegration as jpre
from vins_tpu_torch import convert
from vins_tpu_torch.imu import preintegration as tpre

torch.set_num_threads(1)
N = 64
NOISE = jpre.ImuNoise(acc_n=0.08, gyr_n=0.004, acc_w=4e-5, gyr_w=2e-6)


def samples(seed=0, k=3):
    """k intervals of N steps at ~200 Hz; interval i keeps N - 9i steps."""
    rng = np.random.default_rng(seed)
    t = np.arange(N + 1) / 200.0
    acc = np.stack([1.0 + 0.5 * np.sin(5 * t), -0.3 * np.cos(3 * t), 9.81 + 0.2 * np.sin(2 * t)],
                   -1)[None] + 0.05 * rng.standard_normal((k, N + 1, 3))
    gyr = np.stack([0.3 * np.sin(4 * t), 0.2 * np.cos(6 * t), 0.4 * np.sin(t)], -1)[None] \
        + 0.01 * rng.standard_normal((k, N + 1, 3))
    dt = 1.0 / 200.0 + 1e-4 * rng.standard_normal((k, N))
    mask = np.arange(N)[None, :] < (N - 9 * np.arange(k))[:, None]
    ba = 0.02 * rng.standard_normal((k, 3))
    bg = 0.003 * rng.standard_normal((k, 3))
    return dt, acc, gyr, ba, bg, mask


def jax_batch(fn, dt, acc, gyr, ba, bg, mask):
    """`fn` over the intervals, vmapped and jitted once."""
    out = jax.jit(jax.vmap(lambda d, a, g, b_a, b_g, m: fn(d, a, g, b_a, b_g, NOISE, m)))(
        *[jnp.asarray(x) for x in (dt, acc, gyr, ba, bg, mask)])
    return jpre.Preintegration(*[np.asarray(x) for x in out])


@pytest.fixture(scope="module")
def case():
    s = samples()
    t = [torch.from_numpy(np.asarray(a)) for a in s]
    noise = convert.imu_noise(NOISE)
    return dict(
        jseq=jax_batch(jpre.preintegrate_sequential, *s),
        jpar=jax_batch(jpre.preintegrate, *s),
        tseq=tpre.preintegrate_sequential(*t[:5], noise, t[5]),
        tpar=tpre.preintegrate(*t[:5], noise, t[5]),
    )


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("field", ["dp", "dq", "dv", "J", "P", "sqrt_info", "dt_sum"])
@pytest.mark.parametrize("which", ["tseq-jseq", "tpar-jpar", "tpar-jseq"])
def test_preintegration_matches_jax(case, which, field):
    mine, ref = which.split("-")
    tol = 1e-12 if which == "tseq-jseq" or field in ("dp", "dq", "dv", "dt_sum") else 1e-9
    if field == "sqrt_info":
        tol = 1e-6  # a triangular inverse of P: its conditioning on top of P's 1e-9
    for i in range(3):
        a = getattr(case[mine], field)[i].numpy()
        b = np.asarray(getattr(case[ref], field))[i]
        assert rel_err(a, b) < tol, (which, field, i, rel_err(a, b))


def test_masked_tail_is_identity(case):
    """Interval 2 keeps N-18 steps: the same as integrating only those."""
    dt, acc, gyr, ba, bg, mask = [torch.from_numpy(np.asarray(a)) for a in samples()]
    n = N - 18
    short = tpre.preintegrate(dt[2, :n], acc[2, :n + 1], gyr[2, :n + 1], ba[2], bg[2],
                              convert.imu_noise(NOISE))
    for f in ("dp", "dq", "dv", "J", "P"):
        assert rel_err(getattr(case["tpar"], f)[2], getattr(short, f)) < 1e-12, f


def test_imu_residual_and_sqrt_info(case):
    rng = np.random.default_rng(3)
    jp = jpre.Preintegration(*[np.asarray(x)[1] for x in case["jpar"]])
    tp = convert.preintegration(jp, device="cpu")
    q = rng.standard_normal((2, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    args = [rng.standard_normal(3), q[0], rng.standard_normal(3), 0.01 * rng.standard_normal(3),
            0.001 * rng.standard_normal(3), rng.standard_normal(3), q[1],
            rng.standard_normal(3), 0.01 * rng.standard_normal(3),
            0.001 * rng.standard_normal(3)]
    g = np.array([0.0, 0.0, 9.81])
    for whiten in (False, True):
        jr = np.asarray(jpre.imu_residual(jp, *[jnp.asarray(a) for a in args], jnp.asarray(g),
                                          whiten=whiten))
        tr = tpre.imu_residual(tp, *[torch.from_numpy(a) for a in args], torch.from_numpy(g),
                               whiten=whiten).numpy()
        np.testing.assert_allclose(tr, jr, rtol=1e-9, atol=1e-9 * np.abs(jr).max())
    np.testing.assert_allclose(tpre._sqrt_info(tp.P).numpy(),
                               np.asarray(jpre._sqrt_info(jnp.asarray(jp.P))),
                               rtol=1e-9, atol=1e-9 * np.abs(np.asarray(jp.sqrt_info)).max())
