"""Carry the JAX package's parameters over into the port's types.

Each function takes the reference's NamedTuple (or anything with the same
fields that numpy can read) and returns the port's counterpart on
`device`, so that both packages compute on identical inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import cameras
from .frontend.fused import FrontState
from .sim.render import Room

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
