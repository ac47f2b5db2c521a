"""Port parity of the proxy's inputs and entry points on the CPU.

1. `sim/proxy.proxy_inputs` with the scene's arguments (seed 3, a circuit of
   period 25 s and radius 6 m, 10 Hz frames, 0.5 s, IMU noise on and off):
   its IMU samples and ground-truth poses against those that
   `vins_tpu.sim.proxy.run_proxy` hands a recording stub pipeline (the stub
   publishes every frame, so that the JAX run returns a pose per frame;
   the JAX frames are left blank: the rooms and the pixel noise are each
   package's own draws); times exact, values to 1e-12.  The port's
   `run_proxy` hands the same stub the same call stream and reports
   progress every 20 frames.
2. The rolling-shutter mapping `Pipeline._toffs` (tests/test_td.py:103-111):
   rows 0, 240 and 480 give [0.015, 0, -0.015] s, as the JAX pipeline's.
3. `run_proxy.main` (loop off; loop on with `--debug-image`) and
   `run_longrun.main` over 0.3 s on the CPU into a temporary directory:
   the report, then the JAX tools' JSON keys (read from
   tools/run_proxy.py and tools/run_longrun.py with `ast`) as the last line
   of standard output; files only under `--out-dir`, nothing in results/.
   The runs end before the first initialization attempt (11 frames).
"""
import ast
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vins_tpu.config import VinsConfig as JConfig
from vins_tpu.pipeline import Pipeline as JPipeline
from vins_tpu.sim import proxy as jproxy
from vins_tpu_torch import convert, run_longrun, run_proxy
from vins_tpu_torch.pipeline import Pipeline as TPipeline
from vins_tpu_torch.sim import proxy as tproxy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = dict(seed=3, period=25.0, radius=6.0, frame_hz=10.0)
SECONDS = 0.5


class Recorder:
    """A pipeline stand-in that records the calls a proxy run makes."""

    def __init__(self, camera=None):
        self.camera = camera
        self.imu, self.frames, self.pg_events = [], [], []

    def process_imu(self, t, acc, gyr):
        self.imu.append((float(t), np.asarray(acc, float), np.asarray(gyr, float)))

    def process_image(self, img, t, gumbel=None):
        self.frames.append(float(t))
        return {"published": True}

    def pg_join(self):
        pass

    def shutdown(self):
        pass


class BlankRenderer:
    """The JAX renderer's stand-in: the frames are not compared (the port's
    room and pixel noise are its own draws), so nothing is rendered."""

    def __init__(self, camera, H, W, **kw):
        self.shape = (H, W)

    def render_device(self, p, q):
        return jnp.zeros(self.shape, jnp.float32)


@pytest.fixture(scope="module", params=[True, False], ids=["imu_noise", "exact_imu"])
def both(request):
    noise = request.param
    jstub = Recorder(jproxy.euroc_camera(jnp.float32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jproxy, "RoomRenderer", BlankRenderer)
        jrun = jproxy.run_proxy(duration=SECONDS, pipe=jstub, imu_noise=noise, **SCENE)
    inp = tproxy.proxy_inputs(duration=SECONDS, device="cpu", imu_noise=noise, **SCENE)
    return noise, jstub, jrun, inp


def test_proxy_inputs_equal_jax(both):
    noise, jstub, jrun, inp = both
    t_imu = np.array([s[0] for s in jstub.imu])
    assert len(t_imu) == 4 * 20
    np.testing.assert_array_equal(inp.imu_t.reshape(-1), t_imu)
    np.testing.assert_allclose(inp.acc.reshape(-1, 3), np.stack([s[1] for s in jstub.imu]),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(inp.gyr.reshape(-1, 3), np.stack([s[2] for s in jstub.imu]),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(inp.t, jrun.t)
    np.testing.assert_array_equal(inp.t, np.array(jstub.frames))
    np.testing.assert_allclose(inp.p_gt, jrun.p_gt, rtol=0, atol=1e-12)
    np.testing.assert_allclose(inp.q_gt, jrun.q_gt, rtol=0, atol=1e-12)
    assert len(inp.frames) == len(inp.t) and inp.frames[0].shape == (tproxy.EUROC_H,
                                                                      tproxy.EUROC_W)


def test_imu_noise_switch(both):
    """Without noise the sensor reads the true motion plus the fixed
    biases; with it, white noise of σ_d = n·√hz rides on top."""
    noise, jstub, jrun, inp = both
    traj = tproxy.Trajectory.circuit(radius=SCENE["radius"], period=SCENE["period"], height=1.0)
    a, w = (x.numpy() for x in traj.imu_at_times(torch.from_numpy(inp.imu_t.reshape(-1)),
                                                 torch.tensor([0.0, 0.0, 9.81],
                                                              dtype=torch.float64)))
    da, dw = inp.acc.reshape(-1, 3) - a - tproxy.BA, inp.gyr.reshape(-1, 3) - w - tproxy.BG
    if noise:
        assert 0.2 < da.std() < 0.37 and 0.015 < dw.std() < 0.03
    else:
        assert np.abs(da).max() < 1e-12 and np.abs(dw).max() < 1e-12


def test_port_run_proxy_call_stream(both):
    noise, jstub, jrun, inp = both
    stub, seen = Recorder(), []
    run = tproxy.run_proxy(pipe=stub, inputs=inp, device="cpu",
                           progress=lambda fi, n, ev: seen.append((fi, n)))
    assert [s[0] for s in stub.imu] == [s[0] for s in jstub.imu]
    np.testing.assert_array_equal(np.stack([s[1] for s in stub.imu]), inp.acc.reshape(-1, 3))
    assert stub.frames == jstub.frames
    np.testing.assert_array_equal(run.p_gt, inp.p_gt)
    assert seen == [(0, len(inp.t))] and run.n_loops == 0


def test_default_inputs_unchanged():
    """The defaults are the scene every earlier caller used: seed 0, period
    16 s, radius 4 m, σ = 2 px, 96 texture components."""
    a = tproxy.proxy_inputs(duration=0.2, device="cpu")
    b = tproxy.proxy_inputs(duration=0.2, device="cpu", seed=0, period=16.0, radius=4.0,
                            imu_hz=200.0, imu_noise=True, pix_noise=2.0, tex_k=96)
    for x, y in zip(a, b):
        if isinstance(x, list):
            assert all(torch.equal(u, v) for u, v in zip(x, y))
        else:
            np.testing.assert_array_equal(x, y)
    c = tproxy.proxy_inputs(duration=0.2, device="cpu", pix_noise=0.0)
    assert not torch.equal(a.frames[0], c.frames[0])
    assert float((a.frames[0] - c.frames[0]).std()) == pytest.approx(2.0, rel=0.05)


def test_rolling_shutter_toffs():
    jcfg = JConfig(rolling_shutter=True, rolling_shutter_tr=0.03, image_height=480,
                   image_width=752, loop_closure=False)
    feats = types.SimpleNamespace(uv=np.array([[10.0, 0.0], [10.0, 240.0], [10.0, 480.0]]))
    tpipe = TPipeline(convert.vins_config(jcfg), tproxy.euroc_camera(device="cpu"),
                      device="cpu")
    jpipe = JPipeline(jcfg, jproxy.euroc_camera())
    toff = tpipe._toffs(feats)
    np.testing.assert_allclose(toff, [0.015, 0.0, -0.015], rtol=0, atol=1e-15)
    np.testing.assert_array_equal(toff, jpipe._toffs(feats))
    off = TPipeline(convert.vins_config(JConfig(loop_closure=False)),
                    tproxy.euroc_camera(device="cpu"), device="cpu")
    assert off._toffs(feats) == 0.0


def tool_keys(name: str, var: str) -> tuple[set, set]:
    """Keys of the JSON dict `var` in tools/`name`: those of its literal, and
    those added later by subscript assignment."""
    with open(os.path.join(ROOT, "tools", name)) as f:
        tree = ast.parse(f.read())
    literal, added = set(), set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        tg = node.targets[0]
        if isinstance(tg, ast.Name) and tg.id == var and isinstance(node.value, ast.Dict):
            literal |= {k.value for k in node.value.keys}
        elif isinstance(tg, ast.Subscript) and getattr(tg.value, "id", None) == var:
            added.add(tg.slice.value)
    return literal, added


def results_state():
    d = os.path.join(ROOT, "results")
    return {f: os.stat(os.path.join(d, f)).st_mtime_ns for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("argv,expect", [
    (["--no-loop"], {"proxy_gt.tum", "proxy_no_loop_seed0.json"}),
    (["--loop", "--debug-image", "--seed", "1"], {"proxy_gt.tum", "proxy_loop_seed1.json"}),
], ids=["no_loop", "loop_debug_image"])
def test_run_proxy_main(argv, expect, tmp_path, capsys, monkeypatch):
    literal, added = tool_keys("run_proxy.py", "res")
    assert "stage_ms" in literal and "ate_corrected_m" in added
    before = results_state()
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out"
    res, run = run_proxy.main(argv + ["--device", "cpu", "--duration", "0.3",
                                      "--out-dir", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("frontend ") and any(ln.startswith("position: ")
                                                     for ln in lines)
    printed = json.loads(lines[-1])
    loop = "--loop" in argv
    assert set(printed) == literal | ({"loop_images"} if loop else set())
    assert printed.get("loop_images", 0) == 0
    assert printed["frames_published"] == len(run.events) == 2 and printed["reboots"] == 0
    assert set(os.listdir(out)) == expect
    assert os.listdir(tmp_path) == ["out"]
    assert results_state() == before
    assert (run.pipe.pose_graph is not None) == loop


def test_run_longrun_main(tmp_path, capsys, monkeypatch):
    literal, added = tool_keys("run_longrun.py", "out")
    before = results_state()
    monkeypatch.chdir(tmp_path)
    res, run = run_longrun.main(["--device", "cpu", "--duration", "0.3", "--out-dir", "o"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == literal and not added and printed["frames"] == 2
    assert sorted(os.listdir(tmp_path / "o")) == ["longrun_gt.tum", "proxy_longrun.json"]
    assert os.listdir(tmp_path) == ["o"]
    assert results_state() == before
    cfg, pipe = run.pipe.cfg, run.pipe
    assert pipe.overlap and pipe.pose_graph is not None and not pipe.pg_async  # shut down
    assert (cfg.pg_async, cfg.fast_relocalization, cfg.pg_skip_first_cnt, cfg.pg_skip_cnt,
            cfg.pg_skip_dis, cfg.pg_opt_interval) == (True, True, 10, 2, 0.25, 3.0)
    assert pipe.estimator.dtype == torch.float64


def test_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (run_proxy, run_longrun):
        with pytest.raises(SystemExit, match="no CUDA device"):
            mod.main(["--duration", "0.3"])
