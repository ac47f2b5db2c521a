"""Closed-form small dense linear algebra, batched over leading dims.

PyTorch counterpart of `vins_tpu/core/linalg.py`.  The eigen and singular
decompositions are the same closed forms as the reference, not
`torch.linalg.eigh`/`svd`: the RANSAC decompositions downstream depend on
their sign conventions.
"""
from __future__ import annotations

import math

import torch


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L Lᵀ) x = b for [..., n, k] b by two triangular solves.
    Unlike `torch.cholesky_solve`, whose CUDA path synchronizes the host on
    every call, these only queue work on the device."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def spd_solve(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for SPD H via Jacobi-scaled Cholesky."""
    d = torch.sqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-30))
    Hn = H / d[..., :, None] / d[..., None, :]
    L, _ = torch.linalg.cholesky_ex(Hn)
    return cho_solve(L, (b / d)[..., None])[..., 0] / d


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of [..., 3, 3] matrices."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def det3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of [..., 3, 3] matrices."""
    return (
        M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
        - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
        + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0])
    )


def eigh3x3(M: torch.Tensor):
    """Closed-form eigendecomposition of symmetric [..., 3, 3] matrices
    (trigonometric / Cardano eigenvalues, cross-product eigenvectors).
    Returns (w [..., 3] ascending, V [..., 3, 3] columns)."""
    # constants come from an on-device eye: a tensor made from a Python list
    # would be a blocking host-to-device copy
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    q = (M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2])[..., None, None] / 3.0
    B = M - q * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-38))
    r = torch.clamp(det3x3(B) / (2.0 * p ** 3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    q0 = q[..., 0, 0]
    w2 = q0 + 2.0 * p * torch.cos(phi)                      # largest
    w0 = q0 + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    w1 = 3.0 * q0 - w0 - w2
    w = torch.stack([w0, w1, w2], dim=-1)  # ascending

    def eigvec(lam):
        # v ∝ cross of two rows of (M − λI); pick the most independent pair
        A = M - lam[..., None, None] * eye
        c01 = torch.linalg.cross(A[..., 0, :], A[..., 1, :])
        c02 = torch.linalg.cross(A[..., 0, :], A[..., 2, :])
        c12 = torch.linalg.cross(A[..., 1, :], A[..., 2, :])
        best = torch.stack([torch.sum(c * c, dim=-1) for c in (c01, c02, c12)], dim=-1)
        k = torch.argmax(best, dim=-1)
        cands = torch.stack([c01, c02, c12], dim=-2)
        v = torch.take_along_dim(cands, k[..., None, None], dim=-2)[..., 0, :]
        nv = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        # triple-degenerate M (≈ λI): every direction is an eigenvector
        return torch.where(nv < 1e-18, eye[0], v / torch.clamp(nv, min=1e-20))

    # the cross-product construction needs an ISOLATED eigenvalue; take the
    # most isolated one, then solve the 2×2 restriction to its orthogonal
    # plane in closed form (a repeated pair, as in an essential matrix's
    # (0, 1, 1), has any orthonormal basis of its plane as eigenvectors)
    gap_lo = w[..., 1] - w[..., 0]
    use_lo = gap_lo >= (w[..., 2] - w[..., 1])
    lam_iso = torch.where(use_lo, w[..., 0], w[..., 2])
    v_iso = eigvec(lam_iso)

    ref = torch.where(torch.abs(v_iso[..., :1]) > 0.9, eye[1], eye[0])
    b1 = torch.linalg.cross(v_iso, ref)
    b1 = b1 / torch.clamp(torch.linalg.vector_norm(b1, dim=-1, keepdim=True), min=1e-20)
    b2 = torch.linalg.cross(v_iso, b1)
    Mb1 = (M @ b1[..., None])[..., 0]
    Mb2 = (M @ b2[..., None])[..., 0]
    n11 = torch.sum(b1 * Mb1, dim=-1)
    n12 = torch.sum(b1 * Mb2, dim=-1)
    n22 = torch.sum(b2 * Mb2, dim=-1)
    theta = 0.5 * torch.atan2(2.0 * n12, n11 - n22)
    c, sn = torch.cos(theta), torch.sin(theta)
    e1 = c[..., None] * b1 + sn[..., None] * b2
    e2 = -sn[..., None] * b1 + c[..., None] * b2
    l1 = c * c * n11 + 2 * c * sn * n12 + sn * sn * n22
    l2 = sn * sn * n11 - 2 * c * sn * n12 + c * c * n22
    swap = (l1 > l2)[..., None]
    lo_v = torch.where(swap, e2, e1)
    hi_v = torch.where(swap, e1, e2)
    ul = use_lo[..., None]
    v0 = torch.where(ul, v_iso, lo_v)
    v1 = torch.where(ul, lo_v, hi_v)
    v2 = torch.where(ul, hi_v, v_iso)
    return w, torch.stack([v0, v1, v2], dim=-1)


def svd3x3(E: torch.Tensor):
    """Closed-form SVD of [..., 3, 3] via eigh3x3(EᵀE).  Returns
    (U, s [..., 3] descending, Vt) with the det sign folded into U's last
    column, so U is a proper frame when E has rank ≥ 2."""
    w, V = eigh3x3(E.transpose(-1, -2) @ E)
    s = torch.sqrt(torch.clamp(w.flip(-1), min=0.0))
    Vd = V.flip(-1)
    u0 = (E @ Vd[..., 0:1])[..., 0] / torch.clamp(s[..., 0:1], min=1e-20)
    u1 = (E @ Vd[..., 1:2])[..., 0] / torch.clamp(s[..., 1:2], min=1e-20)
    # re-orthogonalize u1 against u0 (f32 safety) and complete the frame
    u1 = u1 - torch.sum(u0 * u1, dim=-1, keepdim=True) * u0
    u1 = u1 / torch.clamp(torch.linalg.vector_norm(u1, dim=-1, keepdim=True), min=1e-20)
    u2 = torch.linalg.cross(u0, u1)
    # u2 is forced right-handed; flip v2 so E v2 = s2 u2 still holds
    sgn = torch.sum((E @ Vd[..., 2:3])[..., 0] * u2, dim=-1, keepdim=True)
    sgn = torch.where(sgn < 0, -1.0, 1.0).to(E.dtype)
    Vd = torch.cat([Vd[..., :2], Vd[..., 2:3] * sgn[..., None]], dim=-1)
    U = torch.stack([u0, u1, u2], dim=-1)
    return U, s, Vd.transpose(-1, -2)


def smallest_eigvec(M: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of symmetric PSD [..., n, n]
    by ridged inverse iteration with a fixed count: one Cholesky, then
    repeated solves.  `cholesky_ex` does not check its info flag, so it
    neither syncs the host nor raises (a failed factor gives NaN, as JAX's
    does)."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    ridge = 1e-6 * tr[..., None, None] / n + 1e-30
    L, _ = torch.linalg.cholesky_ex(M + ridge * eye)
    v = torch.ones(M.shape[:-1], dtype=M.dtype, device=M.device)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    for _ in range(iters):
        y = cho_solve(L, v[..., None])[..., 0]
        v = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True), min=1e-30)
    return v


def inv2x2(M: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [..., 2, 2] matrices."""
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    inv_det = 1.0 / (a * d - b * c)
    return torch.stack([
        torch.stack([d, -b], -1),
        torch.stack([-c, a], -1),
    ], -2) * inv_det[..., None, None]
