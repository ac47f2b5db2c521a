"""Textured-room image renderer — the real-data proxy.

PyTorch counterpart of `vins_tpu/sim/render.py`: a box room whose six faces
carry analytic band-limited textures (sums of random plane waves),
ray-cast through the calibrated camera model, lens distortion included.
Rendering runs in torch on the renderer's device; the textures are made
from a seed with numpy.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import lie


def spectral_texture_params(rng: np.random.Generator, k: int = 96, f_lo: float = 2.0,
                            f_mid: float = 64.0, f_hi: float = 400.0,
                            hi_amp: float = 0.12) -> np.ndarray:
    """Random plane-wave components for one face, two bands: a fractal
    (amp ∝ 1/√f) low band in [f_lo, f_mid] cycles/span and a flat high band
    in [f_mid, f_hi] that gives few-pixel contrast for corners.  Returns
    [K, 4] rows (fu, fv, phase, amp), float32."""
    kl = k // 2
    kh = k - kl
    f1 = np.exp(rng.uniform(np.log(f_lo), np.log(f_mid), kl))
    a1 = 1.0 / np.sqrt(f1)
    a1 = 0.5 * a1 / np.sum(a1)
    f2 = np.exp(rng.uniform(np.log(f_mid), np.log(f_hi), kh))
    a2 = np.full(kh, hi_amp / np.sqrt(kh))
    f = np.concatenate([f1, f2])
    amp = np.concatenate([a1, a2])
    th = rng.uniform(0.0, 2 * np.pi, k)
    ph = rng.uniform(0.0, 2 * np.pi, k)
    return np.stack([f * np.cos(th), f * np.sin(th), ph, amp], -1).astype(np.float32)


def sample_texture(params: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Evaluate the spectral texture at in-plane coords (a, b) ∈ [0,1]²;
    returns values in [0, 1].  params [K,4], a/b [...]."""
    arg = (2 * math.pi) * (a[..., None] * params[:, 0] + b[..., None] * params[:, 1]) \
        + params[:, 2]
    v = torch.sum(params[:, 3] * torch.cos(arg), dim=-1)
    return torch.clamp(0.5 + 0.75 * v, 0.0, 1.0)


class Room(NamedTuple):
    """Axis-aligned box [lo, hi] with one spectral texture per face, faces
    ordered x=lo, x=hi, y=lo, y=hi, z=lo, z=hi."""

    lo: torch.Tensor        # [3]
    hi: torch.Tensor        # [3]
    textures: torch.Tensor  # [6, K, 4] plane-wave params

    @staticmethod
    def make(seed: int = 7, lo=(-8.0, -8.0, -2.0), hi=(8.0, 8.0, 4.0), k: int = 96,
             device="cuda"):
        rng = np.random.default_rng(seed)
        tex = np.stack([spectral_texture_params(rng, k) for _ in range(6)])
        return Room(torch.tensor(lo, dtype=torch.float32, device=device),
                    torch.tensor(hi, dtype=torch.float32, device=device),
                    torch.as_tensor(tex, device=device))


def _pixel_rays(camera, H: int, W: int, device) -> torch.Tensor:
    """Per-pixel unit ray directions in the camera frame, through the lens
    model (camera.lift undoes distortion)."""
    vv, uu = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device),
                            indexing="ij")
    rays = camera.lift(torch.stack([uu.reshape(-1), vv.reshape(-1)], -1))  # [HW,3]
    return rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)


_FACE_AXES = ((0, 1, 2), (0, 1, 2), (1, 0, 2), (1, 0, 2), (2, 0, 1), (2, 0, 1))


def render(rays: torch.Tensor, p_c: torch.Tensor, R_wc: torch.Tensor, room: Room,
           H: int, W: int) -> torch.Tensor:
    """Ray-cast the box interior: rays [HW,3] in the camera frame, camera at
    p_c with R_wc (world←camera).  Returns [H,W] float32 in [0,255]."""
    d = rays @ R_wc.T  # world-frame directions [HW,3]
    o = p_c[None, :]
    n = rays.shape[0]
    best_t = torch.full((n,), torch.inf, dtype=torch.float32, device=rays.device)
    shade = torch.zeros((n,), dtype=torch.float32, device=rays.device)
    span = room.hi - room.lo
    for f, (ax, ta, tb) in enumerate(_FACE_AXES):
        bound = room.lo[ax] if f % 2 == 0 else room.hi[ax]
        dax = d[:, ax]
        t = (bound - o[:, ax]) / torch.where(torch.abs(dax) < 1e-9,
                                             torch.full_like(dax, 1e-9), dax)
        hit = o + t[:, None] * d
        a = (hit[:, ta] - room.lo[ta]) / span[ta]
        b = (hit[:, tb] - room.lo[tb]) / span[tb]
        inside = (t > 1e-3) & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
        closer = inside & (t < best_t)
        # slight per-face lighting so faces are distinguishable
        v = sample_texture(room.textures[f], a, b) * (0.75 + 0.05 * f)
        best_t = torch.where(closer, t, best_t)
        shade = torch.where(closer, v, shade)
    return (20.0 + 215.0 * shade).reshape(H, W)


class RoomRenderer:
    """Renders grayscale frames of a textured room through a camera model,
    on the device of the camera's tensors."""

    def __init__(self, camera, H: int, W: int, room: Room | None = None,
                 tic=(0.0, 0.0, 0.0), Ric=np.eye(3)):
        self.camera = camera
        self.H, self.W = H, W
        self.device = camera[0].device
        self.room = room if room is not None else Room.make(device=self.device)
        self.tic = torch.as_tensor(np.asarray(tic), dtype=torch.float32, device=self.device)
        self.Ric = torch.as_tensor(np.asarray(Ric), dtype=torch.float32, device=self.device)
        self.rays = _pixel_rays(camera, H, W, self.device)

    def render_device(self, p_b, q_b) -> torch.Tensor:
        """Render from a BODY pose (applies the camera extrinsic); the
        result stays on the device."""
        q_b, p_b = (v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
                    for v in (q_b, p_b))
        R_b = lie.q2R(q_b.to(self.device)).to(torch.float32)
        p_c = p_b.to(device=self.device, dtype=torch.float32) + R_b @ self.tic
        return render(self.rays, p_c, R_b @ self.Ric, self.room, self.H, self.W)

    def render_body(self, p_b, q_b) -> np.ndarray:
        """Host-side copy of `render_device`."""
        return self.render_device(p_b, q_b).cpu().numpy()
