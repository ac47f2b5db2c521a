"""Port parity: `vins_tpu_torch.loop.pose_graph.PoseGraph` against
`vins_tpu.loop.pose_graph.PoseGraph` on the CPU.

The four JAX scenarios (tests/test_loop.py:195, :262, :290 and
tests/test_reloc.py:141) run through both packages on the same fabricated
keyframes (descriptors and points from numpy seeds); the port's
verifications are handed the JAX graph's own RANSAC draws (`PRNGKey(11)`,
split once per verification) through `PoseGraph(gumbel=...)`.  Both must
give the same loop sequence and number of 4-DoF solves, poses and drift
equal to 1e-6.  Maps cross between the packages: a map either one saved
loads into the other with the keyframes equal, and the port loads the
committed two-session map (results/two_session_map.npz, written by the JAX
package).

    python tests/test_torch_pose_graph.py   # rewrites the stored JAX room

writes `vins_tpu_torch/sim/jax_proxy_room.npy`, the JAX proxy room's
textures (jax.random draws), which `test_stored_room_is_the_jax_proxy_room`
holds bitwise.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vins_tpu.loop import pose_graph as jpg
from vins_tpu.loop.retrieval import KeyframeDB as JDB
from vins_tpu.sim import render as jrender
from vins_tpu_torch.core import nplie
from vins_tpu_torch.loop import pose_graph as tpg
from vins_tpu_torch.loop.retrieval import KeyframeDB as TDB
from vins_tpu_torch.sim import proxy

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAP = os.path.join(ROOT, "results", "two_session_map.npz")
QIC, TIC = np.array([1.0, 0, 0, 0]), np.zeros(3)
ID = np.array([1.0, 0, 0, 0])
N_PTS = 64


def jax_proxy_textures() -> np.ndarray:
    """The JAX proxy's room (vins_tpu/sim/proxy.py:99, seed 0) as the JAX
    package's proxy runs draw it: without x64 (tools/run_two_session.py,
    which wrote the committed map, leaves it off), so float32 draws."""
    with jax.enable_x64(False):
        return np.asarray(jrender.Room.make(jax.random.PRNGKey(7), k=96).textures)


def jax_gumbel():
    """The JAX PoseGraph's draws: PRNGKey(11) split once per verification
    (vins_tpu/loop/pose_graph.py:161, :287), gumbel as verify.py:56."""
    state = {"key": jax.random.PRNGKey(11)}

    def draw(shape):
        state["key"], sub = jax.random.split(state["key"])
        return np.asarray(jax.random.gumbel(sub, shape, jnp.float32))

    return draw


class Pkg:
    """One package's keyframe and graph constructors."""

    def __init__(self, name):
        self.name = name

    def kf(self, index, desc, p_body, q_body, points_w, sequence=1):
        """tests/test_loop.py:175's fabricated keyframe: window points =
        corners, descriptors fixed per place."""
        R_c = nplie.q2R(q_body) @ nplie.q2R(QIC)
        p_c = np.asarray(p_body) + nplie.q2R(q_body) @ TIC
        Pc = (points_w - p_c) @ R_c
        uv = Pc[:, :2] / Pc[:, 2:3]
        n = len(desc)
        if self.name == "jax":
            a, ones, mod = jnp.asarray, jnp.ones(n, bool), jpg
        else:
            a, ones, mod = torch.from_numpy, torch.ones(n, dtype=torch.bool), tpg
        return mod.KeyFrame(index=index, stamp=float(index), p_vio=p_body, q_vio=q_body,
                            points_3d=points_w, points_2d_norm=uv, window_desc=a(desc),
                            window_valid=ones, fast_pts_norm=a(uv.copy()), fast_desc=a(desc),
                            fast_valid=ones, sequence=sequence)

    def graph(self, small=True):
        if self.name == "jax":
            db = JDB(64, N_PTS) if small else None
            return jpg.PoseGraph(QIC, TIC, capacity=64 if small else 512, db=db,
                                 exclude_last=3 if small else 50)
        db = TDB(64, N_PTS, device="cpu") if small else None
        return tpg.PoseGraph(QIC, TIC, capacity=64 if small else 512, db=db,
                             exclude_last=3 if small else 50, device="cpu", gumbel=jax_gumbel())


PKGS = {"jax": Pkg("jax"), "port": Pkg("port")}


def rand_desc(seed, n=N_PTS):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((n, 256)) < 0.5, 1.0, -1.0).astype(np.float32)


def points(seed):
    return np.random.default_rng(seed).uniform(-3.0, 3.0, (N_PTS, 3)) + np.array([0, 0, 8.0])


def drift_correction(pkg):
    """tests/test_loop.py:195: 9 places with a drift growing linearly to 1°
    and (0.06, −0.04, 0.03) m, then 3 revisits of place 0."""
    pg = pkg.graph()
    pts_A = points(7)
    dt_full = np.array([0.06, -0.04, 0.03])

    def drifted(p_true, frac):
        R = nplie.ypr2R(np.array([1.0 * frac, 0.0, 0.0]))
        return R @ np.asarray(p_true) + dt_full * frac, nplie.qmul(nplie.R2q(R), ID), R, \
            dt_full * frac

    outs = []
    for i in range(12):
        frac = i / 11
        place = i if i < 9 else 0
        p_true = [0.0, 0.1 * i, 0.0] if i < 9 else [0.02 * (i - 9), 0.0, 0.0]
        p_v, q_v, Rf, tf = drifted(p_true, frac)
        pts = (pts_A + np.array([0.0, 0.0, 40.0 + 10.0 * place])) @ Rf.T + tf
        outs.append(pg.add_keyframe(pkg.kf(i, rand_desc(100 + place), p_v, q_v, pts)))
    return pg, outs


def save_load(pkg, path):
    """tests/test_loop.py:262: 5 keyframes saved, loaded as the base map, and
    a new session's revisit of place 0 relocalizes against it."""
    pts = points(9)
    pg = pkg.graph()
    for i in range(5):
        pg.add_keyframe(pkg.kf(i, rand_desc(200 + i), np.array([0.0, 0.2 * i, 0.0]), ID, pts),
                        detect_loop=False)
    pg.save(path)
    pg2 = pkg.graph()
    pg2.load(path)
    out = pg2.add_keyframe(pkg.kf(5, rand_desc(200), np.array([0.3, -0.1, 0.05]), ID, pts,
                                  sequence=1))
    return pg, pg2, [out]


def two_session(pkg, path):
    """tests/test_loop.py:290: session A loops and is saved; session B loads
    it as the base, revisits places 0..2 with a drift, merges and solves."""
    pts = points(21)
    pg = pkg.graph()
    outs = []
    for i in range(8):
        outs.append(pg.add_keyframe(pkg.kf(i, rand_desc(300 + i), np.array([0.0, 0.25 * i, 0.0]),
                                           ID, pts + np.array([0.0, 0.0, 5.0 * i]))))
    outs.append(pg.add_keyframe(pkg.kf(8, rand_desc(300), np.array([0.03, 0.02, 0.0]), ID,
                                       pts)))
    pg.flush()
    pg.save(path)
    pg2 = pkg.graph()
    pg2.load(path)
    base = (np.stack([k.p for k in pg2.keyframes]).copy(),
            np.stack([k.q for k in pg2.keyframes]).copy())
    drift_t = np.array([0.4, -0.2, 0.1])
    for j in range(4):
        place = min(j, 2)
        p_true = np.array([0.0, 0.25 * place, 0.0])
        outs.append(pg2.add_keyframe(pkg.kf(
            9 + j, rand_desc(300 + place), p_true + drift_t, ID,
            pts + np.array([0.0, 0.0, 5.0 * place]) + drift_t, sequence=1)))
    pg2.flush()
    return pg, pg2, outs, base


def relo_drift(pkg):
    """tests/test_reloc.py:141: a refined loop edge moves the drift at once;
    the sanity gate rejects a wild one."""
    pg = pkg.graph(small=False)
    if pkg.name == "jax":
        zdesc, zval = jnp.zeros((4, 256), jnp.float32), jnp.zeros((4,), bool)
        fpts, fdesc, fval = jnp.zeros((256, 2)), jnp.zeros((256, 256)), jnp.zeros((256,), bool)
    else:
        zdesc, zval = torch.zeros((4, 256)), torch.zeros((4,), dtype=torch.bool)
        fpts, fdesc = torch.zeros((256, 2)), torch.zeros((256, 256))
        fval = torch.zeros((256,), dtype=torch.bool)
    mod = jpg if pkg.name == "jax" else tpg
    for p in ([0.0, 0, 0], [1.0, 0.5, 0]):
        pg.add_keyframe(mod.KeyFrame(
            index=-1, stamp=0.0, p_vio=p, q_vio=ID, points_3d=np.zeros((4, 3)),
            points_2d_norm=np.zeros((4, 2)), window_desc=zdesc, window_valid=zval,
            fast_pts_norm=fpts, fast_desc=fdesc, fast_valid=fval), detect_loop=False)
    pg.keyframes[1].loop_index = 0
    pg.earliest_loop_index = 0
    ok = pg.update_keyframe_loop(1, rel_t=np.array([1.0, 0, 0]), rel_q=ID, rel_yaw=0.0)
    p_c, q_c = pg.correct_pose(np.array([1.0, 0.5, 0]), ID)
    wild = pg.update_keyframe_loop(1, np.array([50.0, 0, 0]), ID, 0.0)
    return ok, wild, p_c, q_c


def host(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_same_graph(jg, tg, atol=1e-6):
    assert len(jg.keyframes) == len(tg.keyframes)
    assert jg.n_optimizes == tg.n_optimizes
    assert jg.earliest_loop_index == tg.earliest_loop_index
    assert [k.loop_index for k in jg.keyframes] == [k.loop_index for k in tg.keyframes]
    for a, b in zip(jg.keyframes, tg.keyframes):
        assert a.sequence == b.sequence
        for f in ("p", "q", "p_vio", "q_vio", "loop_rel_t"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f), rtol=0, atol=atol)
        assert abs(a.loop_rel_yaw - b.loop_rel_yaw) < atol
    for f in ("r_drift", "t_drift"):
        np.testing.assert_allclose(getattr(tg, f), getattr(jg, f), rtol=0, atol=atol)
    for f in ("yaw", "t", "t_vio", "ypr_vio", "loop_to", "loop_t", "loop_yaw", "used",
              "sequence"):
        np.testing.assert_allclose(getattr(tg.graph, f), getattr(jg.graph, f), rtol=0, atol=atol)


def loops(outs):
    return [o["loop"] for o in outs]


@pytest.fixture(scope="module")
def drift_runs():
    return {name: drift_correction(pkg) for name, pkg in PKGS.items()}


@pytest.fixture(scope="module")
def save_load_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("maps")
    return {name: save_load(pkg, str(d / f"{name}.npz")) + (str(d / f"{name}.npz"),)
            for name, pkg in PKGS.items()}


@pytest.fixture(scope="module")
def two_session_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sessions")
    return {name: two_session(pkg, str(d / f"{name}.npz")) + (str(d / f"{name}.npz"),)
            for name, pkg in PKGS.items()}


def test_drift_correction_matches_jax(drift_runs):
    (jg, jout), (tg, tout) = drift_runs["jax"], drift_runs["port"]
    assert loops(tout) == loops(jout)
    assert loops(tout)[9] == 0 and tg.n_optimizes >= 1  # the scenario closed its loop
    for a, b in zip(jout, tout):
        assert a.get("candidate") == b.get("candidate") and a.get("verify") == b.get("verify")
        np.testing.assert_array_equal(b["scores"], a["scores"])
    assert_same_graph(jg, tg)
    last = tg.keyframes[-1]
    p_corr, _ = tg.correct_pose(last.p_vio, last.q_vio)
    assert np.linalg.norm(p_corr - last.p) < 1e-6


def test_save_load_matches_jax(save_load_runs):
    jr, tr = save_load_runs["jax"], save_load_runs["port"]
    assert loops(tr[2]) == loops(jr[2]) and loops(tr[2])[0] is not None
    assert_same_graph(jr[0], tr[0])
    assert_same_graph(jr[1], tr[1])
    assert all(k.sequence == 0 for k in tr[1].keyframes[:5])


def test_two_session_matches_jax_base_bitwise(two_session_runs):
    jr, tr = two_session_runs["jax"], two_session_runs["port"]
    assert loops(tr[2]) == loops(jr[2])
    assert loops(tr[2])[8] == 0 and tr[1].n_optimizes >= 1
    assert_same_graph(jr[0], tr[0])
    assert_same_graph(jr[1], tr[1])
    pg2, (base_p, base_q) = tr[1], tr[3]
    assert pg2.keyframes[8].loop_index == 0 and pg2.earliest_loop_index == 0
    assert 1 in pg2._merged
    # the loaded base map: bitwise unchanged by the solves
    np.testing.assert_array_equal(np.stack([k.p for k in pg2.keyframes[:9]]), base_p)
    np.testing.assert_array_equal(np.stack([k.q for k in pg2.keyframes[:9]]), base_q)
    np.testing.assert_array_equal(pg2.graph.t[:9], base_p)


def test_update_keyframe_loop_matches_jax():
    (jok, jwild, jp, jq), (tok, twild, tp, tq) = relo_drift(PKGS["jax"]), relo_drift(PKGS["port"])
    assert (tok, twild) == (jok, jwild) == (True, False)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tp, [1.0, 0, 0], atol=1e-6)


def assert_same_keyframes(ka, kb):
    assert len(ka) == len(kb)
    for a, b in zip(ka, kb):
        assert (a.stamp, a.sequence, a.loop_index) == (b.stamp, b.sequence, b.loop_index)
        for f in ("p", "q", "p_vio", "q_vio", "loop_rel_t"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.loop_rel_yaw == b.loop_rel_yaw
        for f in ("fast_pts", "fast_desc", "fast_valid"):
            np.testing.assert_array_equal(host(getattr(a, f)), host(getattr(b, f)))


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_maps_cross_between_packages(two_session_runs, saved_by):
    """Session A's map, saved by one package, loads into the other with the
    keyframes equal to the saver's own load; graph arrays included."""
    path = two_session_runs[saved_by][4]
    other = "port" if saved_by == "jax" else "jax"
    pg = PKGS[other].graph()
    pg.load(path)
    own = PKGS[saved_by].graph()
    own.load(path)
    assert_same_keyframes(pg.keyframes, own.keyframes)
    assert pg.earliest_loop_index == own.earliest_loop_index == 0
    for f in ("yaw", "t", "t_vio", "ypr_vio", "loop_to", "loop_t", "loop_yaw", "sequence"):
        np.testing.assert_array_equal(getattr(pg.graph, f), getattr(own.graph, f))


def test_port_loads_the_committed_two_session_map():
    with np.load(MAP) as f:
        d = {k: f[k] for k in f.files}
    pg = tpg.PoseGraph(QIC, TIC, device="cpu")
    pg.load(MAP)
    assert len(pg.keyframes) == 204 == pg.db.count
    li = d["loop_index"]
    assert [k.loop_index for k in pg.keyframes] == li.tolist()
    assert (li >= 0).sum() == 52 and pg.earliest_loop_index == int(li[li >= 0].min())
    np.testing.assert_array_equal(pg.graph.loop_to[:204], li)
    np.testing.assert_array_equal(pg.graph.loop_t[:204], d["loop_rel_t"])
    np.testing.assert_array_equal(np.stack([k.p for k in pg.keyframes]), d["p"])
    np.testing.assert_array_equal(np.stack([k.q for k in pg.keyframes]), d["q"])
    assert all(k.sequence == 0 for k in pg.keyframes)
    np.testing.assert_array_equal(pg.db.desc[:204].numpy(), d["fast_desc"])
    np.testing.assert_array_equal(pg.db.valid[:204].numpy(), d["fast_valid"])


def test_stored_room_is_the_jax_proxy_room():
    room = proxy.jax_proxy_room(device="cpu")
    np.testing.assert_array_equal(room.textures.numpy(), jax_proxy_textures())
    with jax.enable_x64(False):
        jroom = jrender.Room.make(jax.random.PRNGKey(7), k=96)
    np.testing.assert_array_equal(room.lo.numpy(), np.asarray(jroom.lo))
    np.testing.assert_array_equal(room.hi.numpy(), np.asarray(jroom.hi))


if __name__ == "__main__":
    np.save(proxy.JAX_ROOM_FILE, jax_proxy_textures())
    print(f"wrote {proxy.JAX_ROOM_FILE}")
