"""The port stands alone: no module of `vins_tpu_torch` and not
`chip_smoke.py` imports JAX or the JAX package (`vins_tpu`), checked on the
syntax tree of every file (an import inside a function counts too)."""
import ast
import glob
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(glob.glob(os.path.join(ROOT, "vins_tpu_torch", "**", "*.py"), recursive=True)
               ) + [os.path.join(ROOT, "chip_smoke.py")]
FORBIDDEN = ("jax", "jaxlib", "vins_tpu")


def imported_modules(path: str):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_the_port_has_files():
    assert len(FILES) >= 30
    rel = {os.path.relpath(p, ROOT) for p in FILES}
    assert {"vins_tpu_torch/utils/viz.py", "vins_tpu_torch/run_proxy.py",
            "vins_tpu_torch/run_longrun.py", "vins_tpu_torch/calib/intrinsics.py",
            "vins_tpu_torch/calib/chessboard.py", "vins_tpu_torch/ar/overlay.py",
            "vins_tpu_torch/calibrate_camera.py", "vins_tpu_torch/run_two_session.py",
            "vins_tpu_torch/evaluate_ate.py"} <= rel


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
