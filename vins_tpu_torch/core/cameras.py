"""Batched camera models (pinhole+radtan, MEI, Kannala-Brandt, Scaramuzza).

PyTorch counterpart of `vins_tpu/core/cameras.py` (camodocal:
PinholeCamera.cc:489-542, CataCamera.cc:556-640, EquidistantCamera.cc,
ScaramuzzaCamera.cc:598-653).  Each model is a NamedTuple of tensors;
``project`` (camera-frame point → pixel) and ``lift`` (pixel → ray on the
z = 1 plane) broadcast over leading point dims.  Inverse distortion runs a
fixed iteration count, as the reference does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def _tensors(values, dtype, device):
    return [torch.as_tensor(v, dtype=dtype, device=device) for v in values]


def _radtan(cam, x, y):
    r2 = x * x + y * y
    rad = cam.k1 * r2 + cam.k2 * r2 * r2
    dx = x * rad + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    dy = y * rad + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return dx, dy


def _undistort(cam, uv, iters):
    mx_d = (uv[..., 0] - cam.cx) / cam.fx
    my_d = (uv[..., 1] - cam.cy) / cam.fy
    mx_u, my_u = mx_d, my_d
    for _ in range(iters):
        dx, dy = _radtan(cam, mx_u, my_u)
        mx_u = mx_d - dx
        my_u = my_d - dy
    return mx_u, my_u


def _horner(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Σ coeffs[..., i] xⁱ (what jnp.polyval does on the reversed list)."""
    y = torch.zeros_like(x)
    for i in range(coeffs.shape[-1] - 1, -1, -1):
        y = y * x + coeffs[..., i]
    return y


class PinholeCamera(NamedTuple):
    """fx, fy, cx, cy + radial-tangential k1,k2,p1,p2 (PinholeCamera.cc)."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0,
               dtype=torch.float32, device="cuda"):
        return PinholeCamera(*_tensors((fx, fy, cx, cy, k1, k2, p1, p2), dtype, device))

    def project(self, P):
        """Camera-frame 3D point(s) [..., 3] → pixel [..., 2]."""
        x = P[..., 0] / P[..., 2]
        y = P[..., 1] / P[..., 2]
        dx, dy = _radtan(self, x, y)
        return torch.stack([self.fx * (x + dx) + self.cx,
                            self.fy * (y + dy) + self.cy], dim=-1)

    def lift(self, uv, iters: int = 8):
        """Pixel [..., 2] → normalized plane ray [..., 3] (z = 1), inverse
        distortion by `iters` fixed-point steps (PinholeCamera.cc:489-505)."""
        mx_u, my_u = _undistort(self, uv, iters)
        return torch.stack([mx_u, my_u, torch.ones_like(mx_u)], dim=-1)


class MeiCamera(NamedTuple):
    """Unified-sphere (MEI) model: xi + pinhole/radtan (CataCamera.cc)."""

    xi: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor

    @staticmethod
    def create(xi, fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0,
               dtype=torch.float32, device="cuda"):
        return MeiCamera(*_tensors((xi, fx, fy, cx, cy, k1, k2, p1, p2), dtype, device))

    def project(self, P):
        """CataCamera.cc spaceToPlane: sphere projection + radtan + K."""
        z = P[..., 2] + self.xi * torch.linalg.vector_norm(P, dim=-1)
        x = P[..., 0] / z
        y = P[..., 1] / z
        dx, dy = _radtan(self, x, y)
        return torch.stack([self.fx * (x + dx) + self.cx,
                            self.fy * (y + dy) + self.cy], dim=-1)

    def lift(self, uv, iters: int = 8):
        """Pixel → projective ray through the unit sphere, returned on the
        z = 1 plane (CataCamera.cc:556-640)."""
        mx_u, my_u = _undistort(self, uv, iters)
        rho2 = mx_u * mx_u + my_u * my_u
        xi = self.xi
        lam = (xi + torch.sqrt(1.0 + (1.0 - xi * xi) * rho2)) / (1.0 + rho2)
        P = torch.stack([lam * mx_u, lam * my_u, lam - xi], dim=-1)
        return P / P[..., 2:3]


class EquidistantCamera(NamedTuple):
    """Kannala-Brandt θ-polynomial fisheye (EquidistantCamera.cc):
    r(θ) = θ + k2 θ³ + k3 θ⁵ + k4 θ⁷ + k5 θ⁹."""

    k2: torch.Tensor
    k3: torch.Tensor
    k4: torch.Tensor
    k5: torch.Tensor
    mu: torch.Tensor
    mv: torch.Tensor
    u0: torch.Tensor
    v0: torch.Tensor

    @staticmethod
    def create(k2, k3, k4, k5, mu, mv, u0, v0, dtype=torch.float32, device="cuda"):
        return EquidistantCamera(*_tensors((k2, k3, k4, k5, mu, mv, u0, v0), dtype, device))

    def _r(self, theta):
        t2 = theta * theta
        return theta * (1.0 + t2 * (self.k2 + t2 * (self.k3 + t2 * (self.k4 + t2 * self.k5))))

    def _r_prime(self, theta):
        t2 = theta * theta
        return 1.0 + t2 * (3.0 * self.k2 + t2 * (5.0 * self.k3 + t2 * (7.0 * self.k4 + t2 * 9.0 * self.k5)))

    def project(self, P):
        theta = torch.arccos(torch.clamp(P[..., 2] / torch.linalg.vector_norm(P, dim=-1), -1.0, 1.0))
        phi = torch.atan2(P[..., 1], P[..., 0])
        r = self._r(theta)
        return torch.stack([self.mu * r * torch.cos(phi) + self.u0,
                            self.mv * r * torch.sin(phi) + self.v0], dim=-1)

    def lift(self, uv, iters: int = 10):
        """Invert r(θ) by a fixed count of Newton steps."""
        x = (uv[..., 0] - self.u0) / self.mu
        y = (uv[..., 1] - self.v0) / self.mv
        theta_d = torch.sqrt(x * x + y * y)
        phi = torch.atan2(y, x)
        theta = theta_d
        for _ in range(iters):
            f = self._r(theta) - theta_d
            theta = theta - f / torch.clamp(self._r_prime(theta), min=1e-6)
        st, ct = torch.sin(theta), torch.cos(theta)
        P = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)
        return P / P[..., 2:3]


class ScaramuzzaCamera(NamedTuple):
    """OCAM omnidirectional polynomial model (ScaramuzzaCamera.cc:598-653)."""

    poly: torch.Tensor      # [..., 5]  cam2world polynomial over rho
    inv_poly: torch.Tensor  # [..., 20] world2cam polynomial over theta
    C: torch.Tensor
    D: torch.Tensor
    E: torch.Tensor
    center_x: torch.Tensor
    center_y: torch.Tensor

    @staticmethod
    def create(poly, inv_poly, C, D, E, center_x, center_y,
               dtype=torch.float32, device="cuda"):
        return ScaramuzzaCamera(*_tensors((poly, inv_poly, C, D, E, center_x, center_y),
                                          dtype, device))

    def project(self, P):
        """spaceToPlane (ScaramuzzaCamera.cc:632-653)."""
        norm = torch.sqrt(P[..., 0] ** 2 + P[..., 1] ** 2)
        theta = torch.atan2(-P[..., 2], norm)
        rho = _horner(self.inv_poly, theta)
        inv_norm = 1.0 / torch.clamp(norm, min=1e-12)
        xn = P[..., 0] * inv_norm * rho
        yn = P[..., 1] * inv_norm * rho
        return torch.stack([xn * self.C + yn * self.D + self.center_x,
                            xn * self.E + yn + self.center_y], dim=-1)

    def lift(self, uv):
        """liftProjective (ScaramuzzaCamera.cc:598-622)."""
        xc0 = uv[..., 0] - self.center_x
        xc1 = uv[..., 1] - self.center_y
        inv_scale = 1.0 / (self.C - self.D * self.E)
        xa = inv_scale * (xc0 - self.D * xc1)
        ya = inv_scale * (-self.E * xc0 + self.C * xc1)
        phi = torch.sqrt(xa * xa + ya * ya)
        z = _horner(self.poly, phi)
        P = torch.stack([xc0, xc1, -z], dim=-1)
        return P / P[..., 2:3]


def camera_from_yaml(cfg: dict, dtype=torch.float32, device="cuda"):
    """Build a camera model from a camodocal-style config mapping
    (CameraFactory.cc: ``model_type`` ∈ PINHOLE | MEI | KANNALA_BRANDT |
    SCARAMUZZA)."""
    kw = dict(dtype=dtype, device=device)
    mt = str(cfg.get("model_type", "PINHOLE")).upper()
    if mt == "PINHOLE":
        d = cfg["distortion_parameters"]
        p = cfg["projection_parameters"]
        return PinholeCamera.create(
            p["fx"], p["fy"], p["cx"], p["cy"],
            d.get("k1", 0.0), d.get("k2", 0.0), d.get("p1", 0.0), d.get("p2", 0.0), **kw)
    if mt == "MEI":
        d = cfg["distortion_parameters"]
        p = cfg["projection_parameters"]
        return MeiCamera.create(
            cfg["mirror_parameters"]["xi"], p["gamma1"], p["gamma2"], p["u0"], p["v0"],
            d.get("k1", 0.0), d.get("k2", 0.0), d.get("p1", 0.0), d.get("p2", 0.0), **kw)
    if mt == "KANNALA_BRANDT":
        p = cfg["projection_parameters"]
        return EquidistantCamera.create(
            p["k2"], p["k3"], p["k4"], p["k5"], p["mu"], p["mv"], p["u0"], p["v0"], **kw)
    if mt == "SCARAMUZZA":
        p = cfg["poly_parameters"]
        ip = cfg["inv_poly_parameters"]
        a = cfg["affine_parameters"]
        return ScaramuzzaCamera.create(
            [p[f"p{i}"] for i in range(5)], [ip[f"p{i}"] for i in range(20)],
            a["ac"], a["ad"], a["ae"], a["cx"], a["cy"], **kw)
    raise ValueError(f"unknown camera model_type: {mt}")
