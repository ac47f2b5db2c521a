"""Configuration for the port: the reference's per-platform yaml schema.

Counterpart of `vins_tpu/config.py`.  `load_config` reads the
cv::FileStorage flavour of yaml that `config/*.yaml` use without PyYAML:
the ``%YAML:1.0`` directive, ``!!opencv-matrix`` nodes, nested block
mappings, flow sequences (which may span lines), quoted strings and
comments.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class VinsConfig:
    # --- compile-time constants (parameters.h:11-14) ---
    window: int = 10  # WINDOW_SIZE: sliding window of window+1 frames
    max_landmarks: int = 160  # landmark slots in the solver (NUM_OF_F bound)
    focal: float = 460.0  # FOCAL_LENGTH virtual focal for thresholds/weights
    # --- front-end (euroc_config.yaml) ---
    image_width: int = 752
    image_height: int = 480
    max_cnt: int = 150
    min_dist: int = 30
    freq: int = 10
    f_threshold: float = 1.0
    equalize: bool = True
    fisheye: bool = False
    # --- estimator ---
    max_num_iterations: int = 8
    keyframe_parallax: float = 10.0  # pixels, divided by focal in use
    estimate_extrinsic: int = 0  # 0 fixed / 1 optimize / 2 calibrate from scratch
    estimate_td: bool = False
    rolling_shutter: bool = False
    rolling_shutter_tr: float = 0.0
    td: float = 0.0
    init_depth: float = 5.0
    min_parallax_ratio_init: float = 30.0
    # --- IMU noise ---
    acc_n: float = 0.08
    gyr_n: float = 0.004
    acc_w: float = 0.00004
    gyr_w: float = 2.0e-6
    g_norm: float = 9.81007
    # --- loop closure ---
    loop_closure: bool = True
    fast_relocalization: bool = False
    pg_skip_first_cnt: int = 10
    pg_skip_cnt: int = 0
    pg_skip_dis: float = 0.0
    min_loop_num: int = 25
    pg_async: bool = False
    overlap: bool = False
    pg_opt_interval: float = 2.0
    debug_image: bool = False
    # --- camera (parsed separately into a camera model) ---
    camera: dict | None = None
    extrinsic_R: tuple = ((1.0, 0, 0), (0, 1.0, 0), (0, 0, 1.0))  # imu^R_cam
    extrinsic_t: tuple = (0.0, 0.0, 0.0)  # imu^t_cam

    @property
    def frames(self) -> int:
        return self.window + 1

    @property
    def min_parallax(self) -> float:
        """Keyframe parallax threshold on the normalized plane."""
        return self.keyframe_parallax / self.focal


_INT = re.compile(r"[-+]?[0-9]+$")
_FLOAT = re.compile(r"[-+]?([0-9]+\.?[0-9]*|\.[0-9]+)([eE][-+]?[0-9]+)?$")


def _scalar(tok: str):
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "\"'":
        return tok[1:-1]
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    return tok


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_cv_yaml(text: str) -> dict:
    """Parse the cv::FileStorage yaml subset into nested dicts."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.lstrip().startswith("%") or line.strip() == "---":
            continue
        lines.append(line)

    root: dict = {}
    stack = [(-1, root)]  # (indent, mapping)
    i = 0
    while i < len(lines):
        line = lines[i]
        indent = len(line) - len(line.lstrip())
        key, sep, rest = line.strip().partition(":")
        if not sep:
            raise ValueError(f"unsupported yaml line: {line!r}")
        while stack[-1][0] >= indent:
            stack.pop()
        parent = stack[-1][1]
        rest = rest.strip()
        if rest.startswith("!!"):  # a tag such as !!opencv-matrix
            rest = rest.split(None, 1)[1] if " " in rest else ""
        if rest.startswith("["):
            # flow sequence, possibly continued on the following lines
            while "]" not in rest:
                i += 1
                rest += " " + lines[i].strip()
            body = rest[1:rest.index("]")]
            parent[key.strip()] = [_scalar(t) for t in body.split(",") if t.strip()]
        elif rest:
            parent[key.strip()] = _scalar(rest)
        else:
            child: dict = {}
            parent[key.strip()] = child
            stack.append((indent, child))
        i += 1
    return root


def _cv_matrix(node: dict) -> np.ndarray:
    return np.asarray(node["data"], dtype=np.float64).reshape(node["rows"], node["cols"])


_FIELDS = [
    ("image_width", "image_width", int),
    ("image_height", "image_height", int),
    ("max_cnt", "max_cnt", int),
    ("min_dist", "min_dist", int),
    ("freq", "freq", int),
    ("F_threshold", "f_threshold", float),
    ("equalize", "equalize", lambda v: bool(int(v))),
    ("fisheye", "fisheye", lambda v: bool(int(v))),
    ("max_num_iterations", "max_num_iterations", int),
    ("keyframe_parallax", "keyframe_parallax", float),
    ("estimate_extrinsic", "estimate_extrinsic", int),
    ("estimate_td", "estimate_td", lambda v: bool(int(v))),
    ("rolling_shutter", "rolling_shutter", lambda v: bool(int(v))),
    ("rolling_shutter_tr", "rolling_shutter_tr", float),
    ("td", "td", float),
    ("acc_n", "acc_n", float),
    ("gyr_n", "gyr_n", float),
    ("acc_w", "acc_w", float),
    ("gyr_w", "gyr_w", float),
    ("g_norm", "g_norm", float),
    ("loop_closure", "loop_closure", lambda v: bool(int(v))),
    ("fast_relocalization", "fast_relocalization", lambda v: bool(int(v))),
    ("pg_skip_first_cnt", "pg_skip_first_cnt", int),
    ("skip_cnt", "pg_skip_cnt", int),
    ("skip_dis", "pg_skip_dis", float),
]

_CAM_KEYS = ("model_type", "distortion_parameters", "projection_parameters",
             "mirror_parameters", "poly_parameters", "inv_poly_parameters",
             "affine_parameters")


def load_config(path: str) -> VinsConfig:
    """Load a reference-style yaml config file (cv::FileStorage flavour)."""
    with open(path) as f:
        raw = parse_cv_yaml(f.read())
    kw: dict[str, Any] = {field: cast(raw[key]) for key, field, cast in _FIELDS
                          if raw.get(key) is not None}
    kw["camera"] = {k: raw[k] for k in _CAM_KEYS if k in raw}
    if "extrinsicRotation" in raw:
        kw["extrinsic_R"] = tuple(map(tuple, _cv_matrix(raw["extrinsicRotation"])))
    if "extrinsicTranslation" in raw:
        kw["extrinsic_t"] = tuple(_cv_matrix(raw["extrinsicTranslation"]).ravel())
    return VinsConfig(**kw)
