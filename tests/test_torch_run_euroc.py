"""The port's entry points without JAX: `run_euroc.replay` raises in the
calling thread when an image fails to decode, whether or not the aligner
keeps that frame; `run_euroc.main` turns loop closure off only with
`--no-loop`, runs overlapped with the pose graph on its worker thread and
writes both trajectories; `sim/proxy.make_pipeline`'s config is field by
field the one `vins_tpu/sim/proxy.py:53-76` builds, read from that file's
source (so JAX is never imported).

A 3-frame EuRoC tree whose broken frame comes first, at t = 0.5 s, before
the first IMU sample (t = 1.0 s): the aligner drops it, so the replay
skips its image, and that skip must raise too instead of waiting for an
image the prefetch thread will never send.  The same broken frame at
t = 1.05 s, which the aligner keeps, is the case the replay always raised
on.  A stub stands in for the pipeline."""
import ast
import dataclasses
import os
import threading

import numpy as np
import pytest

from vins_tpu.config import VinsConfig as JConfig
from vins_tpu_torch import run_euroc
from vins_tpu_torch.config import VinsConfig
from vins_tpu_torch.io.png import write_png_gray
from vins_tpu_torch.run_euroc import replay
from vins_tpu_torch.sim import proxy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Stub:
    def __init__(self):
        self.images = []

    def process_imu(self, t, acc, gyr):
        pass

    def process_image(self, img, t, gumbel=None):
        self.images.append(t)
        return {}

    def pg_join(self):
        pass

    def shutdown(self):
        pass


def write_tree(root, stamps, broken):
    cam = os.path.join(root, "mav0", "cam0")
    os.makedirs(os.path.join(cam, "data"))
    os.makedirs(os.path.join(root, "mav0", "imu0"))
    img = np.random.default_rng(0).integers(0, 255, (48, 64)).astype(np.uint8)
    with open(os.path.join(cam, "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for k, t in enumerate(stamps):
            name = f"{int(round(t * 1e9))}.png"
            f.write(f"{int(round(t * 1e9))},{name}\n")
            path = os.path.join(cam, "data", name)
            if k == broken:
                with open(path, "wb") as g:
                    g.write(b"not a png")
            else:
                write_png_gray(path, img)
    with open(os.path.join(root, "mav0", "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for t in np.arange(1.0, 1.2 + 1e-9, 0.005):
            f.write(f"{int(round(t * 1e9))},0,0,0,0,0,9.81\n")


@pytest.mark.parametrize("stamps", [(0.5, 1.05, 1.10), (1.05, 1.10, 1.15)],
                         ids=["dropped_frame", "kept_frame"])
def test_replay_raises_on_a_broken_image(tmp_path, stamps):
    write_tree(str(tmp_path), stamps, broken=0)
    result = {}

    def run():
        try:
            replay(str(tmp_path), VinsConfig(), None, pipe=Stub(), progress_every=0)
        except Exception as e:  # noqa: BLE001 — handed to the test thread
            result["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=20)
    assert not th.is_alive(), "replay blocked on a broken image"
    err = result.get("error")
    assert isinstance(err, RuntimeError) and str(err) == "image prefetch failed"
    assert isinstance(err.__cause__, Exception)


@pytest.mark.parametrize("flags, loop", [((), True), (("--no-loop",), False)],
                         ids=["loop", "no_loop"])
def test_main_loop_flag_and_outputs(tmp_path, monkeypatch, flags, loop):
    """tools/run_euroc.py:139-163: loop closure on unless --no-loop,
    pg_async and overlap on, both TUM files asked for."""
    seen = {}

    class Done(Stub):
        trajectory = []

        def write_trajectories(self, path_vio, path_loop=None):
            seen["paths"] = (path_vio, path_loop)

    def fake_replay(root, cfg, cam, loop, max_frames, device):
        seen.update(root=root, cfg=cfg, loop=loop, device=device, max_frames=max_frames)
        return Done()

    monkeypatch.setattr(run_euroc, "replay", fake_replay)
    out = tmp_path / "out"
    run_euroc.main([str(tmp_path), "--out", str(out), "--device", "cpu", "--max-frames", "7",
                    *flags])
    assert seen["loop"] is loop and seen["root"] == str(tmp_path)
    assert seen["cfg"].pg_async and seen["cfg"].overlap
    assert seen["device"] == "cpu" and seen["max_frames"] == 7
    assert seen["paths"] == (str(out / "vins_result_no_loop.tum"),
                             str(out / "vins_result_loop.tum"))
    assert out.is_dir()
    assert run_euroc.parse_args(["r"]).no_loop is False
    assert run_euroc.parse_args(["r", "--no-loop"]).no_loop is True


def _source(rel):
    path = os.path.join(ROOT, rel)
    with open(path) as f:
        return path, ast.parse(f.read())


def jax_proxy_config(**kw):
    """The `VinsConfig` that vins_tpu/sim/proxy.py's `make_pipeline(**kw)`
    builds, evaluated from that function's source: its constants, its
    parameters' defaults and `kw`, keyword by keyword in order (so that
    `cfg_kw.pop` happens before `**cfg_kw`)."""
    env = {"np": np}
    for rel, names in (("vins_tpu/sim/proxy.py", ("EUROC_W", "EUROC_H", "TIC")),
                       ("vins_tpu/sim/window.py", ("R_IC_FORWARD",))):
        path, tree = _source(rel)
        for node in tree.body:
            if not isinstance(node, ast.Assign):
                continue
            target = node.targets[0]
            targets = target.elts if isinstance(target, ast.Tuple) else [target]
            ids = [t.id for t in targets if isinstance(t, ast.Name)]
            if set(ids) & set(names):
                value = eval(compile(ast.Expression(node.value), path, "eval"), env)
                env.update(zip(ids, value) if isinstance(target, ast.Tuple) else {ids[0]: value})
    path, tree = _source("vins_tpu/sim/proxy.py")
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "make_pipeline")
    args = fn.args.args[len(fn.args.args) - len(fn.args.defaults):]
    for a, default in zip(args, fn.args.defaults):
        try:
            env[a.arg] = ast.literal_eval(default)
        except ValueError:  # dtype=jnp.float64: not a config field
            pass
    params = {a.arg for a in fn.args.args}
    env.update({k: v for k, v in kw.items() if k in params})
    env["cfg_kw"] = {k: v for k, v in kw.items() if k not in params}
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "VinsConfig")
    fields = {}
    for k in call.keywords:
        value = eval(compile(ast.Expression(k.value), path, "eval"), env)
        fields.update(value if k.arg is None else {k.arg: value})
    return JConfig(**fields)


@pytest.mark.parametrize("kw", [{}, {"pg_async": True},
                                {"pg_skip_first_cnt": 5, "min_loop_num": 20},
                                {"loop_closure": False, "fast_relocalization": True}],
                         ids=["defaults", "async", "replay_test", "loop_off"])
def test_proxy_config_matches_jax(kw):
    jcfg = jax_proxy_config(**kw)
    tcfg = proxy.make_config(**kw)
    names = [f.name for f in dataclasses.fields(VinsConfig)]
    assert names == [f.name for f in dataclasses.fields(JConfig)]
    for name in names:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert tcfg.loop_closure == kw.get("loop_closure", True) and tcfg.min_loop_num == \
        kw.get("min_loop_num", 25)
