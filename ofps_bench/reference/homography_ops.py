# Frozen copy of the port's plain ``ofps_torch/ops/homography.py`` (the benchmark's
# reference; it imports nothing of the port).
"""Batched homography estimation and decomposition (port of
``ofps_tpu.ops.homography``).

* DLT with Hartley normalization, weight-masked so RANSAC minimal fits and
  inlier refits share one code path;
* Gauss-Newton polish on the weighted forward transfer error;
* analytic SVD-based decomposition (Ma/Soatto, "An Invitation to 3-D
  Vision", alg. 5.2) into the two distinct (R, t, n) families, with the
  pure-rotation degenerate case projected by Newton polar iteration.

Every function takes leading batch dims: points (..., N, 2), weights
(..., N), homographies (..., 3, 3).
"""

from __future__ import annotations

import torch

from ofps_bench.reference.epipolar import (
    _cross,
    gram,
    hartley_normalization,
    homogeneous,
    transform_points,
)
from ofps_bench.reference.solve import (
    _eye,
    det3,
    eigh3x3,
    gauss_solve,
    inv3x3,
    smallest_eigvecs_inverse_iteration,
    svd3x3,
)


def _t(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(-1, -2)


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.matmul(m, v[..., None])[..., 0]


def dlt_homography(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted normalized DLT: H with x2 ~ H x1.  (..., N, 2), (..., N, 2),
    (..., N) -> (..., 3, 3), scaled so h22 = 1 where |h22| > 1e-12."""
    t1 = hartley_normalization(x1, w)
    t2 = hartley_normalization(x2, w)
    p1 = transform_points(homogeneous(x1), t1)
    p2 = transform_points(homogeneous(x2), t2)
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    rows_a = torch.stack([-u1, -v1, -o, z, z, z, u2 * u1, u2 * v1, u2], dim=-1)
    rows_b = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    rows = torch.cat([rows_a * w[..., None], rows_b * w[..., None]], dim=-2)
    ata = gram(rows, rows)
    vecs = smallest_eigvecs_inverse_iteration(ata, 1)
    h = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    h = torch.matmul(torch.matmul(inv3x3(t2), h), t1)
    h22 = h[..., 2, 2]
    fro = torch.sqrt(torch.sum(h * h, dim=(-2, -1)))
    scale = torch.where(torch.abs(h22) > 1e-12, h22, fro)
    return h / scale[..., None, None]


def homography_transfer_error(h: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """Squared forward transfer error ||x2 - proj(H x1)||^2.

    ``h`` (..., 3, 3) and the points (..., N, 2) broadcast over their
    leading dims (models (*lead, M, 3, 3) against points (*lead, 1, N, 2)
    give (*lead, M, N))."""
    p = transform_points(homogeneous(x1), h)
    z = p[..., 2]
    z = torch.where(torch.abs(z) > 1e-12, z, torch.full_like(z, 1e-12))
    proj = p[..., :2] / z[..., None]
    return torch.sum((proj - x2) ** 2, dim=-1)


def gn_refine_homography(
    h: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor,
    iters: int = 3,
) -> torch.Tensor:
    """Gauss-Newton polish of H on the weighted forward transfer error:
    8-parameter chart with h22 = 1, analytic Jacobian, Levenberg damping,
    each step kept only where the weighted SSE strictly improves."""

    def sse(hm):
        return torch.sum(homography_transfer_error(hm, x1, x2) * w, dim=-1)

    x1h = homogeneous(x1)  # (..., N, 3)
    eye8 = _eye(8, str(h.device))

    def step(hm):
        h22 = hm[..., 2, 2]
        scale = torch.where(torch.abs(h22) > 1e-12, h22, torch.ones_like(h22))
        hm = hm / scale[..., None, None]
        p = transform_points(x1h, hm)
        z = p[..., 2]
        z = torch.where(torch.abs(z) > 1e-12, z, torch.full_like(z, 1e-12))
        proj = p[..., :2] / z[..., None]
        r = (proj - x2) * w[..., None]  # (..., N, 2) weighted residuals
        invz = 1.0 / z
        # Jacobian wrt theta = (h00..h02, h10..h12, h20, h21), h22 = 1.
        zero3 = torch.zeros_like(x1h)
        xz = x1h * invz[..., None]
        j0 = torch.cat([xz, zero3, -p[..., 0:1] * x1h[..., :2] * (invz**2)[..., None]], dim=-1)
        j1 = torch.cat([zero3, xz, -p[..., 1:2] * x1h[..., :2] * (invz**2)[..., None]], dim=-1)
        jw = torch.cat([j0 * w[..., None], j1 * w[..., None]], dim=-2)  # (..., 2N, 8)
        rr = torch.cat([r[..., 0], r[..., 1]], dim=-1)
        jtj = gram(jw, jw)
        # Levenberg damping keeps near-singular systems stable.
        tr = torch.diagonal(jtj, dim1=-2, dim2=-1).sum(-1)
        jtj = jtj + (1e-8 * tr / 8.0)[..., None, None] * eye8
        jtr = gram(jw, rr[..., None])[..., 0]
        delta = gauss_solve(jtj, -jtr[..., None])[..., 0]
        upd = torch.cat([delta, torch.zeros_like(delta[..., :1])], dim=-1)
        cand = hm + upd.reshape(upd.shape[:-1] + (3, 3))
        keep = sse(cand) < sse(hm)
        return torch.where(keep[..., None, None], cand, hm)

    for _ in range(iters):
        h = step(h)
    return h


def decompose_homography(h: torch.Tensor, k: torch.Tensor):
    """Decompose screen-space H (..., 3, 3) with intrinsics K (3, 3) into
    candidate (R, t, n): (rs (..., 2, 3, 3), ts (..., 2, 3), ns (..., 2, 3)).

    The +-(t, n) sign twins share R, so two families suffice.  Where
    s1^2 - s3^2 < 1e-4 (pure rotation) both families take the orthogonal
    projection of the calibrated homography by 4 Newton polar steps and
    t = 0: the family formulas divide by that gap.
    """
    hn = torch.matmul(torch.matmul(inv3x3(k), h), k)
    # Scale so the middle singular value is 1.
    _, s, _ = svd3x3(hn)
    hn = hn / s[..., 1, None, None]

    lam, v = eigh3x3(torch.matmul(_t(hn), hn))  # ascending: s3^2 <= 1 <= s1^2
    s3sq, s1sq = lam[..., 0], lam[..., 2]
    v3, v2, v1 = v[..., :, 0], v[..., :, 1], v[..., :, 2]

    denom = torch.clamp(s1sq - s3sq, min=1e-12)
    a = torch.sqrt(torch.clamp(1.0 - s3sq, min=0.0) / denom)[..., None]
    b = torch.sqrt(torch.clamp(s1sq - 1.0, min=0.0) / denom)[..., None]
    u1 = a * v1 + b * v3
    u2 = a * v1 - b * v3

    def family(u):
        n = _cross(v2, u)
        big_u = torch.stack([v2, u, n], dim=-1)
        hv2 = _matvec(hn, v2)
        hu = _matvec(hn, u)
        big_w = torch.stack([hv2, hu, _cross(hv2, hu)], dim=-1)
        r = torch.matmul(big_w, _t(big_u))
        t = _matvec(hn - r, n)
        return r, t, n

    r1, t1, n1 = family(u1)
    r2, t2, n2 = family(u2)

    degenerate = ((s1sq - s3sq) < 1e-4)[..., None]
    r_rot = hn
    for _ in range(4):
        det = det3(r_rot)
        det = torch.where(torch.abs(det) > 1e-20, det, torch.full_like(det, 1e-20))
        # Cofactor rows / det = inv(X)^T; X <- (X + X^-T) / 2.
        cof = torch.stack([
            _cross(r_rot[..., 1, :], r_rot[..., 2, :]),
            _cross(r_rot[..., 2, :], r_rot[..., 0, :]),
            _cross(r_rot[..., 0, :], r_rot[..., 1, :]),
        ], dim=-2)
        r_rot = 0.5 * (r_rot + cof / det[..., None, None])
    zero_t = torch.zeros_like(t1)

    r1 = torch.where(degenerate[..., None], r_rot, r1)
    t1 = torch.where(degenerate, zero_t, t1)
    r2 = torch.where(degenerate[..., None], r_rot, r2)
    t2 = torch.where(degenerate, zero_t, t2)
    return (
        torch.stack([r1, r2], dim=-3),
        torch.stack([t1, t2], dim=-2),
        torch.stack([n1, n2], dim=-2),
    )
