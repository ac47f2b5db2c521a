"""The two-session entry point against the JAX tool, on the CPU (no JAX
program runs here).

- The keyword arguments of `tools/run_two_session.py`'s two
  `make_pipeline` and two `run_proxy` calls and the keys of its JSON, read
  from its source with `ast`; `vins_tpu_torch.run_two_session.main` with
  `make_pipeline` / `run_proxy` stubbed to record makes the same calls
  (the device aside, each duration from its flag, defaults 24 / 24), saves
  the map once and loads it once, and prints one JSON line with the same
  keys, nested as JAX's.
- One short real run (`--device cpu --duration-a 2.5 --duration-b 0.5`;
  2.5 s is about the shortest that hands keyframes to the pose graph):
  the map and the JSON go to `--out-dir`, nothing under `results/`
  changes, session B's pose graph holds the n_base loaded keyframes as
  sequence 0, the base is bitwise unchanged, and the last line printed is
  the JSON, with JAX's keys.
"""
import ast
import contextlib
import io
import json
import os
import types

import numpy as np
import pytest
import torch

from vins_tpu_torch import run_two_session

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "run_two_session.py")


def _tool_main():
    with open(TOOL) as f:
        tree = ast.parse(f.read())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def _value(node):
    """A literal, or the attribute's name (`jnp.float32` → "float32"), or
    the name itself (`pipe_a`)."""
    try:
        return ast.literal_eval(node)
    except ValueError:
        return node.attr if isinstance(node, ast.Attribute) else node.id


def jax_calls(name: str) -> list:
    """Keyword arguments of each call to `name` in the tool's main, in order."""
    calls = [n for n in ast.walk(_tool_main()) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == name]
    calls.sort(key=lambda n: n.lineno)
    return [{k.arg: _value(k.value) for k in c.keywords} for c in calls]


def _keys(node: ast.Dict) -> dict:
    return {_value(k): (_keys(v) if isinstance(v, ast.Dict) else None)
            for k, v in zip(node.keys, node.values)}


def jax_json_keys() -> dict:
    """The nested keys of the tool's `out = {...}`."""
    node = next(n for n in ast.walk(_tool_main()) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "out")
    return _keys(node.value)


def keys_of(d) -> dict:
    return {k: (keys_of(v) if isinstance(v, dict) else None) for k, v in d.items()}


class KeyFrame(types.SimpleNamespace):
    pass


class StubGraph:
    def __init__(self, log):
        self.log, self.keyframes, self._merged, self.n_optimizes = log, [], set(), 0

    def save(self, path):
        self.log.append(("save", path))
        with open(path, "wb") as f:
            f.write(b"map")

    def load(self, path):
        self.log.append(("load", path))
        self.keyframes = [KeyFrame(p=np.ones(3), q=np.array([1.0, 0, 0, 0]), loop_index=-1,
                                   stamp=1.0, sequence=0) for _ in range(3)]


def stubbed(monkeypatch):
    log = []

    def make_pipeline(**kw):
        log.append(("make_pipeline", kw))
        traj = [(float(t), np.array([t, 0.0, 0.0]), np.array([1.0, 0, 0, 0])) for t in range(5)]
        return types.SimpleNamespace(pose_graph=StubGraph(log), trajectory=traj,
                                     trajectory_loop=traj)

    def run_proxy(**kw):
        log.append(("run_proxy", {k: v for k, v in kw.items() if k != "pipe"}))
        pipe = kw["pipe"]
        if pipe.pose_graph.keyframes:  # session B: one new keyframe looped to the base
            pipe.pose_graph.keyframes.append(KeyFrame(p=np.zeros(3), q=np.array([1.0, 0, 0, 0]),
                                                      loop_index=1, stamp=2.6, sequence=1))
            pipe.pose_graph._merged.add(1)
        else:
            pipe.pose_graph.keyframes = [KeyFrame() for _ in range(3)]
        return types.SimpleNamespace(t=np.arange(5.0), p_gt=np.arange(5.0)[:, None] * [1, 0, 0],
                                     n_loops=2)

    monkeypatch.setattr(run_two_session, "make_pipeline", make_pipeline)
    monkeypatch.setattr(run_two_session, "run_proxy", run_proxy)
    return log


def run_main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = run_two_session.main(argv)
    return out, buf.getvalue().strip().splitlines()


@pytest.mark.parametrize("argv,durations", [([], (24.0, 24.0)),
                                            (["--duration-a", "3", "--duration-b", "2"],
                                             (3.0, 2.0))], ids=["defaults", "flags"])
def test_calls_match_the_jax_tool(monkeypatch, tmp_path, argv, durations):
    log = stubbed(monkeypatch)
    (out, _, _), lines = run_main([*argv, "--device", "cpu", "--out-dir", str(tmp_path)])
    made = [kw for what, kw in log if what == "make_pipeline"]
    runs = [kw for what, kw in log if what == "run_proxy"]
    jmake, jrun = jax_calls("make_pipeline"), jax_calls("run_proxy")
    assert len(made) == len(jmake) == 2 and len(runs) == len(jrun) == 2
    for got, want in zip(made, jmake):
        assert got.pop("device") == "cpu" and got.pop("dtype") == torch.float32
        want.pop("dtype")  # jnp.float32
        assert got == want
    for got, want, duration in zip(runs, jrun, durations):
        assert got.pop("device") == "cpu" and got.pop("duration") == duration
        want.pop("pipe")
        assert want.pop("duration") == 24.0
        assert got == want
    saves = [p for what, p in log if what == "save"]
    loads = [p for what, p in log if what == "load"]
    assert saves == loads == [str(tmp_path / "two_session_map.npz")]
    assert keys_of(out) == keys_of(json.loads(lines[-1])) == jax_json_keys()
    with open(tmp_path / "two_session.json") as f:
        assert json.load(f) == out
    assert out["session_b"]["loops_to_base_map"] == 1 and out["session_b"]["merged_onto_base"]
    assert out["session_b"]["first_reloc_stamp"] == 2.6 and out["base_map_bitwise_unchanged"]


def test_map_goes_to_a_temporary_file(monkeypatch):
    log = stubbed(monkeypatch)
    run_main(["--device", "cpu"])
    (save,) = [p for what, p in log if what == "save"]
    assert not os.path.exists(save) and not save.startswith(os.path.join(ROOT, "results"))


def _results_state():
    d = os.path.join(ROOT, "results")
    return {f: os.stat(os.path.join(d, f)).st_mtime_ns for f in sorted(os.listdir(d))}


def test_short_real_run(tmp_path):
    torch.set_num_threads(8)
    before = _results_state()
    (out, run_a, run_b), lines = run_main(["--device", "cpu", "--duration-a", "2.5",
                                           "--duration-b", "0.5", "--out-dir", str(tmp_path)])
    assert _results_state() == before
    assert sorted(os.listdir(tmp_path)) == ["two_session.json", "two_session_map.npz"]
    n_base = out["session_a"]["keyframes"]
    assert n_base == len(run_a.pipe.pose_graph.keyframes) >= 1
    pg_b = run_b.pipe.pose_graph
    assert [k.sequence for k in pg_b.keyframes[:n_base]] == [0] * n_base
    with np.load(tmp_path / "two_session_map.npz") as m:
        np.testing.assert_array_equal(np.stack([k.p for k in pg_b.keyframes[:n_base]]), m["p"])
        np.testing.assert_array_equal(np.stack([k.q for k in pg_b.keyframes[:n_base]]), m["q"])
    assert out["base_map_bitwise_unchanged"] is True
    # session B ends before its initialization: its ATEs are NaN, printed as such
    assert lines[-1] == json.dumps(out) and keys_of(json.loads(lines[-1])) == jax_json_keys()
    assert run_a.pipe.estimator.prior.J.dtype == torch.float32
