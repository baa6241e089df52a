# Frozen copy of the port's plain ``ofps_torch/ops/epipolar.py`` (the benchmark's
# reference; it imports nothing of the port).
"""Batched epipolar geometry (port of ``ofps_tpu.ops.epipolar``):
fundamental and essential matrices, pose recovery and refinement.

Image points are (..., N, 2) in [0, 1] screen space with (..., N) weights
(0/1 masks or soft weights); matrices are (..., 3, 3); leading dims are
batch (streams, hypotheses).  The epipolar constraint is ``x2^T F x1 = 0``
for correspondences x1 -> x2, and E = [t]x R with X2 = R X1 + t.

Every function is a fixed sequence of tensor operations (no host
synchronisation), so it can be captured in a CUDA graph.  Determinants are
:func:`ops.solve.det3` (elementwise) where the JAX package takes an LU
determinant: only signs and a Newton divisor depend on them.
"""

from __future__ import annotations

import math

import torch

from ofps_bench.reference.robust import _take
from ofps_bench.reference.solve import (
    _eye,
    det3,
    gauss_solve,
    inv3x3,
    smallest_eigvecs_inverse_iteration,
    svd3x3,
)

# Products whose inner dimension is tiny (3) or whose reduction runs over
# the points are written as a broadcast multiply and a sum: cuBLAS takes
# its worst tiles for both shapes (on an H100 ten point-reduction products
# took 2.7 of the homography estimator's 6.2 ms of kernel time at B=4;
# PERF.md).


def gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """aᵀ b over the second-to-last (point) dim: (..., N, I), (..., N, J)
    -> (..., I, J), summed over N."""
    return torch.sum(a[..., :, :, None] * b[..., :, None, :], dim=-3)


def transform_points(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` (..., N, 3) through ``m`` (..., 3, 3): x mᵀ, with the
    leading dims broadcast; the three products summed in order."""
    m = m[..., None, :, :]
    return (x[..., :, None, 0] * m[..., 0] + x[..., :, None, 1] * m[..., 1]
            + x[..., :, None, 2] * m[..., 2])


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def homogeneous(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def hartley_normalization(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Similarity transform T with T*p at zero weighted centroid and mean
    distance sqrt(2).  ``p``: (..., N, 2); ``w``: (..., N).  Returns
    (..., 3, 3)."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    c = torch.sum(p * w[..., None], dim=-2) / wsum[..., None]
    diff = p - c[..., None, :]
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))
    mean_d = torch.sum(d * w, dim=-1) / wsum
    s = math.sqrt(2.0) / torch.clamp(mean_d, min=1e-12)
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    return torch.stack(
        [
            torch.stack([s, z, -s * c[..., 0]], -1),
            torch.stack([z, s, -s * c[..., 1]], -1),
            torch.stack([z, z, o], -1),
        ],
        dim=-2,
    )


def _normalize_pts(p: torch.Tensor, w: torch.Tensor):
    t = hartley_normalization(p, w)
    return transform_points(homogeneous(p), t)[..., :2], t


def epipolar_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Design-matrix rows (..., N, 9) of x2ᵀ F x1 = 0, F flattened row-major."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    return torch.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], dim=-1
    )


def _weighted_normal_matrix(x1, x2, w):
    """(T1, T2, AᵀA) of the Hartley-normalized weighted design matrix."""
    x1n, t1 = _normalize_pts(x1, w)
    x2n, t2 = _normalize_pts(x2, w)
    rows = epipolar_rows(x1n, x2n) * w[..., None]
    return t1, t2, gram(rows, rows)


def _as3x3(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape[:-1] + (3, 3))


def eight_point_fundamental(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted normalized 8-point fundamental matrix (rank 2, unit
    Frobenius norm): (..., N, 2), (..., N, 2), (..., N) -> (..., 3, 3)."""
    t1, t2, ata = _weighted_normal_matrix(x1, x2, w)
    f = _as3x3(smallest_eigvecs_inverse_iteration(ata, 1)[..., 0])
    u, s, vt = svd3x3(f)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    f = torch.matmul(u * s[..., None, :], vt)
    # Denormalize: x2ᵀ T2ᵀ F T1 x1 = 0.
    f = torch.matmul(torch.matmul(t2.transpose(-1, -2), f), t1)
    norm = torch.sqrt(torch.sum(f * f, dim=(-2, -1)))
    return f / torch.clamp(norm, min=1e-20)[..., None, None]


def _cubic_roots_real(c0, c1, c2, c3):
    """Real roots of c3 x³ + c2 x² + c1 x + c0 = 0, closed form: (roots
    (..., 3), valid (..., 3) bool).  Three roots by the trigonometric method
    where the discriminant is <= 0, else Cardano's single root (first slot
    valid); c3 ~ 0 is replaced by 1e-20."""
    c3s = torch.where(torch.abs(c3) > 1e-20, c3, torch.full_like(c3, 1e-20))
    a = c2 / c3s
    b = c1 / c3s
    c = c0 / c3s
    # Depressed cubic t³ + p t + q with x = t - a/3.
    p = b - a * a / 3.0
    q = 2.0 * (a * a * a) / 27.0 - a * b / 3.0 + c
    q2, p3 = q / 2.0, p / 3.0
    disc = q2 * q2 + p3 * p3 * p3
    p_neg = torch.clamp(p, max=-1e-20)
    m = 2.0 * torch.sqrt(-p_neg / 3.0)
    theta = torch.arccos(torch.clamp(3.0 * q / (p_neg * m), -1.0, 1.0)) / 3.0
    k = torch.arange(3, dtype=p.dtype, device=p.device)
    trig = m[..., None] * torch.cos(theta[..., None] - 2.0 * math.pi * k / 3.0) - (a / 3.0)[..., None]
    sq = torch.sqrt(torch.clamp(disc, min=0.0))

    def cbrt(v):
        return torch.sign(v) * torch.abs(v) ** (1.0 / 3.0)

    single = cbrt(-q / 2.0 + sq) + cbrt(-q / 2.0 - sq) - a / 3.0
    three = (disc <= 0.0)[..., None]
    roots = torch.where(three, trig, single[..., None])
    valid = three | (k == 0)
    return roots, valid


def seven_point_fundamental(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor):
    """7-point fundamental: up to 3 candidates (..., 3, 3, 3) and their
    validity (..., 3), from the 2-D null space and the cubic det = 0."""
    t1, t2, ata = _weighted_normal_matrix(x1, x2, w)
    basis = smallest_eigvecs_inverse_iteration(ata, 2)  # (..., 9, 2)
    f1 = _as3x3(basis[..., :, 0])
    f2 = _as3x3(basis[..., :, 1])
    # det(f1 + lam f2) = c0 + c1 lam + c2 lam² + c3 lam³
    c0 = det3(f1)
    c3 = det3(f2)
    dp = det3(f1 + f2)
    dm = det3(f1 - f2)
    c2 = (dp + dm) / 2.0 - c0
    c1 = (dp - dm) / 2.0 - c3
    lam, valid = _cubic_roots_real(c0, c1, c2, c3)
    fs = f1[..., None, :, :] + lam[..., None, None] * f2[..., None, :, :]
    fs = torch.matmul(torch.matmul(t2.transpose(-1, -2)[..., None, :, :], fs), t1[..., None, :, :])
    norms = torch.sqrt(torch.sum(fs * fs, dim=(-2, -1)))
    return fs / torch.clamp(norms, min=1e-20)[..., None, None], valid


def _epipolar_terms(f: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """For F (..., 3, 3) against points (..., N, 2), broadcast: x2ᵀ F x1 and
    the first two components of F x1 and Fᵀ x2, each (..., N)."""
    x, y = x1[..., 0], x1[..., 1]
    u, v = x2[..., 0], x2[..., 1]
    f = f[..., None, :, :]
    fx0 = f[..., 0, 0] * x + f[..., 0, 1] * y + f[..., 0, 2]
    fx1 = f[..., 1, 0] * x + f[..., 1, 1] * y + f[..., 1, 2]
    fx2 = f[..., 2, 0] * x + f[..., 2, 1] * y + f[..., 2, 2]
    ft0 = f[..., 0, 0] * u + f[..., 1, 0] * v + f[..., 2, 0]
    ft1 = f[..., 0, 1] * u + f[..., 1, 1] * v + f[..., 2, 1]
    return u * fx0 + v * fx1 + fx2, (fx0, fx1, ft0, ft1)


def _sq_sum(terms) -> torch.Tensor:
    return sum(t * t for t in terms)


def sampson_error(f: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) squared error per correspondence.
    ``f`` (..., 3, 3) and the points (..., N, 2) broadcast over their
    leading dims (models (*lead, M, 3, 3) against points (*lead, 1, N, 2)
    give (*lead, M, N))."""
    num, terms = _epipolar_terms(f, x1, x2)
    return num * num / torch.clamp(_sq_sum(terms), min=1e-20)


def essential_from_fundamental(f: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """E = Kᵀ F K."""
    return torch.matmul(torch.matmul(k.transpose(-1, -2), f), k)


def project_to_essential(e: torch.Tensor) -> torch.Tensor:
    """Closest true essential matrix: equal nonzero singular values."""
    u, s, vt = svd3x3(e)
    sm = (s[..., 0] + s[..., 1]) / 2.0
    s_new = torch.stack([sm, sm, torch.zeros_like(sm)], dim=-1)
    return torch.matmul(u * s_new[..., None, :], vt)


def decompose_essential(e: torch.Tensor):
    """Four (R, t) candidates of E: (rs (..., 4, 3, 3), ts (..., 4, 3))."""
    u, _, vt = svd3x3(e)
    # Make proper rotations.
    u = u * torch.sign(det3(u))[..., None, None]
    vt = vt * torch.sign(det3(vt))[..., None, None]
    c0, c1, c2 = u[..., :, 0], u[..., :, 1], u[..., :, 2]
    uw = torch.stack([c1, -c0, c2], dim=-1)  # U W, W = [[0,-1,0],[1,0,0],[0,0,1]]
    uwt = torch.stack([-c1, c0, c2], dim=-1)  # U Wᵀ
    r1 = torch.matmul(uw, vt)
    r2 = torch.matmul(uwt, vt)
    rs = torch.stack([r1, r1, r2, r2], dim=-3)
    ts = torch.stack([c2, -c2, c2, -c2], dim=-2)
    return rs, ts


def triangulate_depths(r: torch.Tensor, t: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """Depths (z1, z2) of normalized rays x1, x2 (..., 2) under X2 = R X1 +
    t, from the two-ray least squares ``z2 d2 = z1 R d1 + t``, d = (x, y,
    1); r (..., 3, 3) and t (..., 3) broadcast against the rays."""
    d1 = homogeneous(x1)
    d2 = homogeneous(x2)
    rd1 = torch.sum(r * d1[..., None, :], dim=-1)
    a11 = torch.sum(rd1 * rd1, dim=-1)
    a12 = -torch.sum(rd1 * d2, dim=-1)
    a22 = torch.sum(d2 * d2, dim=-1)
    b1 = -torch.sum(rd1 * t, dim=-1)
    b2 = torch.sum(d2 * t, dim=-1)
    det = a11 * a22 - a12 * a12
    det = torch.where(torch.abs(det) > 1e-20, det, torch.full_like(det, 1e-20))
    z1 = (b1 * a22 - a12 * b2) / det
    z2 = (a11 * b2 - a12 * b1) / det
    return z1, z2


def recover_pose_from_essential(e, x1n, x2n, w):
    """Cheirality-based (R, t) selection (OpenCV recoverPose parity).

    ``x1n``/``x2n``: (..., N, 2) normalized camera coordinates; ``w``:
    (..., N).  Returns (r (..., 3, 3), t (..., 3), support (...))."""
    rs, ts = decompose_essential(e)
    z1, z2 = triangulate_depths(rs[..., None, :, :], ts[..., None, :],
                                x1n[..., None, :, :], x2n[..., None, :, :])
    sup = torch.sum(((z1 > 0) & (z2 > 0)).to(w.dtype) * w[..., None, :], dim=-1)  # (..., 4)
    # Tie-break (exactly degenerate fields tie all four): prefer the
    # smaller rotation, by a bonus below any genuine support difference.
    tr = torch.diagonal(rs, dim1=-2, dim2=-1).sum(-1)
    best = torch.argmax(sup + 0.2 * (tr + 1.0) / 4.0, dim=-1, keepdim=True)  # first maximum
    return tuple(_take(x, best).squeeze(best.dim() - 1) for x in (rs, ts, sup))


def _cross_mat(t: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(t[..., 0])
    return torch.stack(
        [
            torch.stack([z, -t[..., 2], t[..., 1]], -1),
            torch.stack([t[..., 2], z, -t[..., 0]], -1),
            torch.stack([-t[..., 1], t[..., 0], z], -1),
        ],
        dim=-2,
    )


def _rodrigues(omega: torch.Tensor) -> torch.Tensor:
    """R = exp([omega]x) for (..., 3) rotation vectors, as
    ``I + A(th)[w]x + B(th)[w]x²`` with Taylor-guarded A = sin(th)/th and
    B = (1 - cos th)/th²: differentiable at omega = 0, where Gauss-Newton
    linearizes (a ``where(th > eps, R, I)`` form has a zero tangent there)."""
    th2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    small = th2 < 1e-12
    th2s = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2s)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2s)
    wcross = _cross_mat(omega)
    eye = _eye(3, str(omega.device)).to(omega.dtype)
    return eye + a[..., None] * wcross + b[..., None] * torch.matmul(wcross, wcross)


def _unit_axes(like: torch.Tensor):
    """The x and y unit vectors, built on ``like``'s device."""
    k = torch.arange(3, device=like.device)
    return (k == 0).to(like.dtype), (k == 1).to(like.dtype)


def refine_pose_sampson(r0, t0, x1n, x2n, w, iters: int = 3):
    """Gauss-Newton polish of (R, t) minimizing the weighted Sampson error
    of E = [t]x R over normalized correspondences (..., N, 2), weights
    (..., N), on the 5-DOF motion manifold: a rotation vector left-applied
    to R and 2 coefficients over a basis orthogonal to t.  Each step
    linearizes the signed residual at 0 with its analytic Jacobian (the
    tangent ``jax.jacfwd`` takes in the JAX package) and solves the 5x5
    normal equations; a step is kept only where it strictly reduces the
    weighted SSE and is finite, so degenerate data is a no-op."""
    tnorm0 = _norm(t0, keepdim=True)
    tn = t0 / torch.clamp(tnorm0, min=1e-20)
    ex, ey = _unit_axes(t0)
    a = torch.where(torch.abs(tn[..., :1]) < 0.9, ex, ey)
    b1 = _cross(tn, a)
    b1 = b1 / torch.clamp(_norm(b1, keepdim=True), min=1e-20)
    b2 = _cross(tn, b1)
    x1e, x2e = x1n[..., None, :, :], x2n[..., None, :, :]
    eye5 = _eye(5, str(r0.device)).to(r0.dtype)
    gens = torch.stack([_cross_mat(e) for e in (ex, ex.roll(1), ex.roll(2))])  # [e_k]x

    def residual(r, t):
        num, terms = _epipolar_terms(torch.matmul(_cross_mat(t), r), x1n, x2n)
        return num * torch.rsqrt(torch.clamp(_sq_sum(terms), min=1e-20))

    def residual_and_jacobian(r, t):
        tx = _cross_mat(t)
        e = torch.matmul(tx, r)
        # dE/dp: [t]x [e_k]x R for the rotation vector, [b_j]x R for t.
        de_rot = torch.matmul(torch.matmul(tx[..., None, :, :], gens), r[..., None, :, :])
        de_t = torch.matmul(_cross_mat(torch.stack([b1, b2], dim=-2)), r[..., None, :, :])
        num, (fx0, fx1, ft0, ft1) = _epipolar_terms(e, x1n, x2n)  # (..., N)
        dnum, (dx0, dx1, dt0, dt1) = _epipolar_terms(
            torch.cat([de_rot, de_t], dim=-3), x1e, x2e)  # (..., 5, N)
        den = fx0 * fx0 + fx1 * fx1 + ft0 * ft0 + ft1 * ft1
        dden = 2.0 * (fx0[..., None, :] * dx0 + fx1[..., None, :] * dx1
                      + ft0[..., None, :] * dt0 + ft1[..., None, :] * dt1)
        live = den > 1e-20  # the clamp's derivative is 0 below it
        rs = torch.rsqrt(torch.clamp(den, min=1e-20))
        res = num * rs
        drs = torch.where(live, -0.5 * rs * rs * rs, torch.zeros_like(rs))
        jac = dnum * rs[..., None, :] + (num * drs)[..., None, :] * dden
        return res, jac.transpose(-1, -2)  # (..., N), (..., N, 5)

    def sse(res):
        return torch.sum(w * res * res, dim=-1)

    r, t = r0, tn
    best = sse(residual(r, t))
    for _ in range(iters):
        res, jac = residual_and_jacobian(r, t)
        jw = jac * w[..., None]
        g = gram(jw, jac)
        tr = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)
        g = g + (1e-8 * tr + 1e-20)[..., None, None] * eye5
        rhs = -gram(jw, res[..., None])[..., 0]
        step = gauss_solve(g, rhs[..., None])[..., 0]
        r_new = torch.matmul(_rodrigues(step[..., :3]), r)
        t_new = t + step[..., 3:4] * b1 + step[..., 4:5] * b2
        t_new = t_new / torch.clamp(_norm(t_new, keepdim=True), min=1e-20)
        new = sse(residual(r_new, t_new))
        good = (new < best) & torch.isfinite(step).all(-1)
        r = torch.where(good[..., None, None], r_new, r)
        t = torch.where(good[..., None], t_new, t)
        best = torch.where(good, new, best)
    return r, t * tnorm0


def _bearings(xn: torch.Tensor) -> torch.Tensor:
    d = homogeneous(xn)
    return d / _norm(d, keepdim=True)


def rotation_only_fallback(r, x1n, x2n, w, ratio: float = 0.5, iters: int = 6):
    """Rotation-only (weighted Kabsch) fallback for epipolar-degenerate
    (near pure rotation) data.

    Fits the rotation-only model on the bearing vectors, the orthogonal
    projection done by Newton polar iteration, and takes it where it
    explains the correspondences decisively better (``ratio``) than the
    epipolar rotation ``r`` (..., 3, 3).  ``x1n, x2n``: (..., N, 2)
    normalized coordinates; ``w``: (..., N).  Returns ``(r', used)``."""
    d1 = _bearings(x1n)
    d2 = _bearings(x2n)
    rk = gram(d2 * w[..., None], d1)  # sum_n w d2 d1ᵀ
    for _ in range(iters):
        det = det3(rk)
        det = torch.where(torch.abs(det) > 1e-20, det, torch.full_like(det, 1e-20))
        cof = torch.stack([
            _cross(rk[..., 1, :], rk[..., 2, :]),
            _cross(rk[..., 2, :], rk[..., 0, :]),
            _cross(rk[..., 0, :], rk[..., 1, :]),
        ], dim=-2)
        rk = 0.5 * (rk + cof / det[..., None, None])

    def resid(rm):
        pred = transform_points(d1, rm)
        c = _cross(d2, pred)
        return torch.sum(torch.sum(c * c, dim=-1) * w, dim=-1)

    use_k = (resid(rk) <= ratio * resid(r)) & (det3(rk) > 0.0)
    return torch.where(use_k[..., None, None], rk, r), use_k


def motion_from_essential_and_correspondence(e, k, x1, x2):
    """(R, t, support) from E (..., 3, 3) by the cheirality of one
    correspondence x1 -> x2 (..., 2) in screen units; K (3, 3)."""
    kinv = inv3x3(k)
    h1 = torch.sum(kinv * homogeneous(x1)[..., None, :], dim=-1)
    h2 = torch.sum(kinv * homogeneous(x2)[..., None, :], dim=-1)
    x1n = h1[..., :2] / h1[..., 2:]
    x2n = h2[..., :2] / h2[..., 2:]
    return recover_pose_from_essential(
        e, x1n[..., None, :], x2n[..., None, :], torch.ones_like(x1n[..., :1]))
