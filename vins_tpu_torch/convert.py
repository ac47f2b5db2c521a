"""Carry the JAX package's parameters over into the port's types.

Each function takes the reference's NamedTuple (or anything with the same
fields that numpy can read) and returns the port's counterpart on
`device`, so that both packages compute on identical inputs.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from .config import VinsConfig
from .core import cameras
from .frontend.fused import FrontState
from .imu.preintegration import ImuNoise, Preintegration
from .sim.driver import SyntheticDriver
from .sim.render import Room
from .sim.window import WindowProblem
from .solver.ba import BAState
from .solver.problem import FeatureObs, Prior, WindowState

_CAMERAS = {cls.__name__: cls for cls in (
    cameras.PinholeCamera, cameras.MeiCamera, cameras.EquidistantCamera,
    cameras.ScaramuzzaCamera)}


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)  # a copy, same dtype


def camera(cam, device="cuda"):
    """A camera NamedTuple of the reference → the port's camera of the same
    model, keeping each field's dtype."""
    cls = _CAMERAS[type(cam).__name__]
    return cls(*[_tensor(getattr(cam, f), device) for f in cls._fields])


def room(src, device="cuda") -> Room:
    """`Room(lo, hi, textures)` → the port's room."""
    return Room(*[_tensor(getattr(src, f), device) for f in Room._fields])


def front_state(src, device="cuda") -> FrontState:
    """A reference `FrontState` → the port's front state."""
    return FrontState(*[_tensor(getattr(src, f), device) for f in FrontState._fields])


def window_state(src, device="cuda") -> WindowState:
    """A reference `WindowState` → the port's."""
    return WindowState(*[_tensor(getattr(src, f), device) for f in WindowState._fields])


def feature_obs(src, device="cuda") -> FeatureObs:
    """A reference `FeatureObs` → the port's (anchor as int64)."""
    out = FeatureObs(*[_tensor(getattr(src, f), device) for f in FeatureObs._fields])
    return out._replace(anchor=out.anchor.long())


def prior(src, device="cuda") -> Prior:
    """A reference `Prior` → the port's."""
    return Prior(J=_tensor(src.J, device), r0=_tensor(src.r0, device),
                 lin=window_state(src.lin, device),
                 valid=_tensor(src.valid, device).bool())


def preintegration(src, device="cuda") -> Preintegration:
    """A reference `Preintegration` (batched or not) → the port's."""
    return Preintegration(*[_tensor(getattr(src, f), device) for f in Preintegration._fields])


def window_problem(src, device="cuda") -> WindowProblem:
    """A reference `WindowProblem` (`vins_tpu/sim/window.py`) → the port's."""
    return WindowProblem(state_true=window_state(src.state_true, device),
                         obs=feature_obs(src.obs, device), pres=preintegration(src.pres, device),
                         **{f: _tensor(getattr(src, f), device) for f in WindowProblem._fields[3:]})


def synthetic_driver(src) -> SyntheticDriver:
    """A reference `SyntheticDriver` (`vins_tpu/sim/driver.py`) → the port's
    with its landmarks, rates, biases, gravity and `tic`/`qic`, so both
    packages project the same points.  The trajectory is the port's
    figure-8, the reference driver's default (its closures do not carry
    over)."""
    dst = SyntheticDriver(n_points=0, imu_hz=src.imu_hz, frame_hz=src.frame_hz,
                          g_norm=float(np.asarray(src.gravity)[2]), ba=np.array(src.ba),
                          bg=np.array(src.bg), tic=np.asarray(src.tic))
    dst.points = _tensor(src.points, "cpu")
    dst.qic = _tensor(src.qic, "cpu")
    dst.max_cnt = src.max_cnt
    return dst


def ba_state(src, device="cuda") -> BAState:
    """A reference `BAState` (`vins_tpu/solver/ba.py`) → the port's."""
    return BAState(*[_tensor(getattr(src, f), device) for f in BAState._fields])


def imu_noise(src) -> ImuNoise:
    return ImuNoise(*[float(getattr(src, f)) for f in ImuNoise._fields])


def vins_config(src) -> VinsConfig:
    """A reference `VinsConfig` → the port's (same fields)."""
    return VinsConfig(**{f.name: getattr(src, f.name)
                         for f in dataclasses.fields(VinsConfig)})


_ESTIMATOR_HOST = (
    "frame_count", "solver_flag", "initial_timestamp", "first_imu", "failures",
    "p", "q", "v", "ba", "bg", "td", "timestamps", "imu_dt", "imu_acc", "imu_gyr",
    "imu_n", "acc_prev", "gyr_prev", "imu_overflow", "aux_t", "aux_ids", "aux_pt",
    "aux_dt", "aux_acc", "aux_gyr", "aux_n", "aux_count", "_acc_dt", "_acc_acc",
    "_acc_gyr", "_acc_n", "last_p", "last_cost", "_post_init_costs",
    "init_rejected_by_health", "qic", "tic", "estimate_extrinsic", "ex_calib_done",
)
_DB_FIELDS = ("ids", "pt", "vel", "uv", "toff", "valid", "inv_depth", "n_dropped",
              "_min_parallax")


def estimator_state(src, dst):
    """Copy a reference `Estimator`'s whole state — host arrays, feature DB,
    pending relo match and the (device) prior — into the port `Estimator`
    `dst`, which then continues from where `src` stands.  Returns `dst`."""
    for obj, names, target in ((src, _ESTIMATOR_HOST, dst), (src.db, _DB_FIELDS, dst.db)):
        for name in names:
            setattr(target, name, copy.deepcopy(getattr(obj, name)))
    dst._relo = copy.deepcopy(src._relo)
    dst.prior = prior(src.prior, dst.device)
    return dst
