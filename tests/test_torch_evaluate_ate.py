"""Port parity of the ATE scoring tool on the CPU.

`vins_tpu_torch/evaluate_ate.py` against `tools/evaluate_ate.py`: a TUM
trajectory and an EuRoC ground-truth file written from a numpy seed (a
yawed, shifted, noisy copy of the truth at another rate); the printout
equal line for line in yaw+t and in `--se3` alignment and with a tighter
`--max-dt`; the helpers equal on the same arrays; too few associations
exit 1 with the same line.
"""
import contextlib
import importlib.util
import io
import os

import numpy as np
import pytest

from vins_tpu_torch import evaluate_ate as tev

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "tools_evaluate_ate", os.path.join(ROOT, "tools", "evaluate_ate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ate")
    rng = np.random.default_rng(7)
    t_gt = 1.0 + np.arange(0.0, 12.0, 0.005)  # 200 Hz truth
    p_gt = np.stack([3 * np.cos(0.4 * t_gt), 2 * np.sin(0.4 * t_gt), 1 + 0.2 * np.sin(t_gt)], -1)
    q_gt = np.tile([1.0, 0.0, 0.0, 0.0], (len(t_gt), 1))
    gt_path = str(d / "data.csv")
    with open(gt_path, "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], q_RS_w [], q_RS_x [], "
                "q_RS_y [], q_RS_z []\n")
        for t, p, q in zip(t_gt, p_gt, q_gt):
            f.write(f"{int(round(t * 1e9))},{p[0]:.9f},{p[1]:.9f},{p[2]:.9f},"
                    f"{q[0]},{q[1]},{q[2]},{q[3]}\n")
    t_e = 1.0 + np.arange(0.0, 11.9, 0.1) + rng.normal(0.0, 0.004, 119)  # 10 Hz, jittered
    th = 0.3
    Rz = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    p_e = np.stack([np.interp(t_e, t_gt, p_gt[:, k]) for k in range(3)], -1) @ Rz.T \
        + [0.5, -0.2, 0.1] + rng.normal(0.0, 0.05, (len(t_e), 3))
    traj = str(d / "traj.tum")
    np.savetxt(traj, np.concatenate([t_e[:, None], p_e, np.tile([0.0, 0.0, 0.0, 1.0],
                                                                (len(t_e), 1))], 1))
    short = str(d / "short.tum")
    np.savetxt(short, np.loadtxt(traj)[:8])
    return traj, short, gt_path


def printout(main, argv):
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            main(argv)
        except SystemExit as e:
            code = e.code
    return buf.getvalue(), code


@pytest.mark.parametrize("extra", [[], ["--se3"], ["--max-dt", "0.003"]],
                         ids=["yaw_t", "se3", "max_dt"])
def test_printout_equals_jax(files, extra, monkeypatch):
    traj, _, gt = files
    tool = jax_tool()
    monkeypatch.setattr("sys.argv", ["evaluate_ate.py", traj, gt, *extra])
    want, code_j = printout(lambda argv: tool.main(), None)
    got, code_t = printout(tev.main, [traj, gt, *extra])
    assert code_j == code_t == 0
    assert got == want and want.startswith("matched ")
    assert len(want.splitlines()) == 3


def test_too_few_associations(files, monkeypatch):
    _, short, gt = files
    tool = jax_tool()
    monkeypatch.setattr("sys.argv", ["evaluate_ate.py", short, gt])
    want, code_j = printout(lambda argv: tool.main(), None)
    got, code_t = printout(tev.main, [short, gt])
    assert code_j == code_t == 1 and got == want == "too few associations\n"


def test_helpers_equal_jax(files):
    traj, _, gt = files
    tool = jax_tool()
    for a, b in zip(tev.load_tum(traj), tool.load_tum(traj)):
        np.testing.assert_array_equal(a, b)
    t, p, _ = tev.load_tum(traj)
    g = tev.load_groundtruth(gt)
    j, ok = tev.associate(t, g.t)
    jj, okj = tool.associate(t, g.t)
    np.testing.assert_array_equal(j, jj)
    np.testing.assert_array_equal(ok, okj)
    P, G = p[ok], g.p[j[ok]]
    np.testing.assert_array_equal(tev.align_yaw_t(P, G), tool.align_yaw_t(P, G))
    np.testing.assert_array_equal(tev.align_se3(P, G), tool.align_se3(P, G))
