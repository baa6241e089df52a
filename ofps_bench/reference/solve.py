# Frozen copy of the port's plain ``ofps_torch/ops/solve.py`` (the benchmark's
# reference; it imports nothing of the port).
"""Small batched linear-algebra helpers shared by the estimators (port of
``ofps_tpu.ops.solve``).

Closed-form and fixed-step solvers over leading batch dims, in float32:
Cramer and adjugate 3x3s, unpivoted and pivoted Gauss-Jordan, block
inverse iteration for the smallest eigenvectors, and the analytic
symmetric 3x3 eigendecomposition and SVD.  Every function is a fixed
sequence of tensor operations (no host synchronisation), so it can be
captured in a CUDA graph; singular inputs give the documented fallback
instead of raising.
"""

from __future__ import annotations

import functools

import torch


def det3(a: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3)."""
    return (
        a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
        - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
        + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0])
    )


def solve3x3(a: torch.Tensor, b: torch.Tensor, fallback: float = 0.0) -> torch.Tensor:
    """Solve ``a @ x = b`` for (..., 3, 3) and (..., 3) by Cramer's rule;
    singular systems return ``fallback``."""
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-1])
    a = a.expand(lead + (3, 3))
    d = det3(a)
    cols = []
    for i in range(3):
        ai = a.clone()
        ai[..., :, i] = b
        cols.append(det3(ai))
    x = torch.stack(cols, dim=-1)
    safe = torch.abs(d) > 1e-30
    return torch.where(
        safe[..., None], x / torch.where(safe, d, torch.ones_like(d))[..., None],
        torch.full_like(x, fallback),
    )


def gauss_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched unpivoted Gauss-Jordan solve: (..., n, n) @ x = (..., n, k).

    For the SPD / diagonally regularized systems the estimators build
    (normal equations), where unpivoted elimination is stable.
    """
    n = a.shape[-1]
    aug = _augment(a, b)
    for k in range(n):
        piv = aug[..., k : k + 1, :] / aug[..., k : k + 1, k : k + 1]
        nxt = aug - aug[..., :, k : k + 1] * piv
        nxt[..., k, :] = piv[..., 0, :]
        aug = nxt
    return aug[..., n:]


def _augment(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[a | b] over the broadcast leading dims of a (..., n, n), b (..., n, k)."""
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    return torch.cat([a.expand(lead + a.shape[-2:]), b.expand(lead + b.shape[-2:])], dim=-1)


def gauss_solve_pivoted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched Gauss-Jordan with partial pivoting: (..., n, n) @ x = (..., n, k).

    For general (non-SPD) systems whose leading pivot may be near zero.
    Pivot selection and row swaps are one-hot masked updates; singular
    systems yield non-finite entries for the caller to gate.
    """
    n = a.shape[-1]
    aug = _augment(a, b)
    rows = torch.arange(n, device=a.device)
    for k in range(n):
        col = torch.abs(aug[..., :, k])
        col = torch.where(rows >= k, col, torch.full_like(col, -1.0))
        p = torch.argmax(col, dim=-1)  # first maximum, as jnp.argmax
        onehot_p = (rows == p[..., None]).to(aug.dtype)
        onehot_k = (rows == k).to(aug.dtype)
        pivot_row = torch.sum(onehot_p[..., None] * aug, dim=-2)
        delta = (pivot_row - aug[..., k, :])[..., None, :]
        aug = aug + onehot_k[..., None] * delta - onehot_p[..., None] * delta
        piv = aug[..., k, k]
        safe = torch.where(torch.abs(piv) > 1e-30, piv, torch.full_like(piv, 1e-30))
        factor = torch.where(rows != k, aug[..., :, k] / safe[..., None],
                             torch.zeros_like(aug[..., :, k]))
        aug = aug - factor[..., None] * aug[..., k, None, :]
    diag = torch.diagonal(aug[..., :, :n], dim1=-2, dim2=-1)
    return aug[..., :, n:] / diag[..., None]


@functools.lru_cache(maxsize=32)
def _eye(n: int, device: str) -> torch.Tensor:
    return torch.eye(n, dtype=torch.float32, device=device)


def gauss_inverse(a: torch.Tensor) -> torch.Tensor:
    """Batched unpivoted Gauss-Jordan inverse of (..., n, n): the same
    elimination as :func:`gauss_solve` with an identity right-hand side."""
    n = a.shape[-1]
    return gauss_solve(a, _eye(n, str(a.device)).to(a.dtype))


def inv3x3(a: torch.Tensor, fallback: float = 0.0) -> torch.Tensor:
    """Analytic (adjugate / det) inverse of (..., 3, 3); singular input
    returns ``fallback``."""
    cof = torch.stack(
        [
            torch.linalg.cross(a[..., 1, :], a[..., 2, :], dim=-1),
            torch.linalg.cross(a[..., 2, :], a[..., 0, :], dim=-1),
            torch.linalg.cross(a[..., 0, :], a[..., 1, :], dim=-1),
        ],
        dim=-1,
    )  # columns: inv(A) * det
    det = torch.sum(a[..., 0, :] * cof[..., :, 0], dim=-1)
    safe = torch.abs(det) > 1e-30
    return torch.where(
        safe[..., None, None],
        cof / torch.where(safe, det, torch.ones_like(det))[..., None, None],
        torch.full_like(cof, fallback),
    )


@functools.lru_cache(maxsize=32)
def _start_block(n: int, k: int, device: str) -> torch.Tensor:
    """The inverse iteration's fixed, generic start block (n, k)."""
    return (torch.eye(n, k, dtype=torch.float32, device=device)
            + 0.01 * torch.arange(1.0, n * k + 1.0, dtype=torch.float32,
                                  device=device).reshape(n, k))


def _norm(x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    """Euclidean norm over the last dim: sqrt of the sum of squares."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def smallest_eigvecs_inverse_iteration(
    ata: torch.Tensor, k: int = 1, iters: int = 3, eps_rel: float = 1e-7
) -> torch.Tensor:
    """k eigenvectors of symmetric PSD (..., n, n) with the smallest
    eigenvalues, columns orthonormal: (..., n, k).

    Block inverse iteration with Gram-Schmidt from a fixed start block,
    after one explicit Gauss-Jordan inverse of the ``eps_rel``-shifted
    matrix.  For RANSAC minimal fits the target eigenvalues are (near-)zero
    with a healthy gap, so 3 iterations converge; more iterations amplify
    float32 noise once converged, so keep 3.
    """
    n = ata.shape[-1]
    dev = str(ata.device)
    tr = torch.diagonal(ata, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    shifted = ata + (eps_rel * tr / n + 1e-30) * _eye(n, dev)
    v = _start_block(n, k, dev).expand(ata.shape[:-2] + (n, k))
    inv = gauss_inverse(shifted)
    for _ in range(iters):
        v = torch.matmul(inv, v)
        cols = []
        for j in range(k):
            c = v[..., :, j]
            for cprev in cols:
                c = c - torch.sum(c * cprev, dim=-1, keepdim=True) * cprev
            c = c / torch.clamp(_norm(c), min=1e-30)
            cols.append(c)
        v = torch.stack(cols, dim=-1)
    return v


def eigh3x3(a: torch.Tensor):
    """Analytic symmetric 3x3 eigendecomposition (ascending eigenvalues).

    Cardano eigenvalues and cross-product eigenvectors (the largest column
    of (A - o1 I)(A - o2 I), first maximum).  Returns (vals (..., 3), vecs
    (..., 3, 3)) with ``vecs[..., :, i]`` the i-th eigenvector.
    """
    eye = _eye(3, str(a.device))
    q = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1) / 3.0
    b = a - q[..., None, None] * eye
    p2 = torch.sum(b * b, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    detb = det3(b)
    r = detb / torch.clamp(2.0 * p**3, min=1e-30)
    phi = torch.arccos(torch.clamp(r, -1.0, 1.0)) / 3.0
    two_pi_3 = 2.0943951023931953
    e0 = q + 2.0 * p * torch.cos(phi + two_pi_3)  # smallest
    e2 = q + 2.0 * p * torch.cos(phi)  # largest
    e1 = 3.0 * q - e0 - e2
    vals = torch.stack([e0, e1, e2], dim=-1)

    def eigvec(other1, other2):
        # (A - o1 I)(A - o2 I) columns span the remaining eigenspace.
        m = torch.matmul(a - other1[..., None, None] * eye,
                         a - other2[..., None, None] * eye)
        norms = torch.sum(m * m, dim=-2)
        best = torch.argmax(norms, dim=-1)  # first maximum
        v = torch.gather(m, -1, best[..., None, None].expand(m.shape[:-1] + (1,)))[..., 0]
        n = _norm(v)
        # Degenerate (repeated eigenvalue): fall back to an axis vector.
        fallback = eye[0].expand(v.shape)
        return torch.where(n > 1e-20, v / torch.clamp(n, min=1e-30), fallback)

    v0 = eigvec(e1, e2)
    v2 = eigvec(e0, e1)
    # Orthogonalize v2 against v0 and complete the triad.
    v2 = v2 - torch.sum(v2 * v0, dim=-1, keepdim=True) * v0
    n2 = _norm(v2)
    alt = torch.linalg.cross(v0, eye[0].expand(v0.shape), dim=-1)
    alt_n = _norm(alt)
    alt2 = torch.linalg.cross(v0, eye[1].expand(v0.shape), dim=-1)
    alt = torch.where(alt_n > 0.1, alt / torch.clamp(alt_n, min=1e-30),
                      alt2 / torch.clamp(_norm(alt2), min=1e-30))
    v2 = torch.where(n2 > 1e-10, v2 / torch.clamp(n2, min=1e-30), alt)
    v1 = torch.linalg.cross(v2, v0, dim=-1)
    return vals, torch.stack([v0, v1, v2], dim=-1)


def svd3x3(m: torch.Tensor):
    """Analytic SVD of (..., 3, 3) from :func:`eigh3x3` of ``MᵀM``: returns
    (u, s, vt), s descending.

    The left factor comes from ``M V / s`` with a cross-product completion
    for (near-)zero singular values.  Like any analytic eigh, directions are
    unreliable on a (near-)fully repeated spectrum (M close to a rotation):
    project a near-rotation with Newton polar iteration instead, as
    ``ops.homography.decompose_homography`` does.
    """
    ata = torch.matmul(m.transpose(-1, -2), m)
    vals, vecs = eigh3x3(ata)
    s = torch.sqrt(torch.clamp(torch.flip(vals, dims=(-1,)), min=0.0))  # descending
    v = torch.flip(vecs, dims=(-1,))  # columns reordered to match
    mv = torch.matmul(m, v)
    u0 = mv[..., :, 0] / torch.clamp(s[..., 0:1], min=1e-30)
    u1 = mv[..., :, 1] / torch.clamp(s[..., 1:2], min=1e-30)
    u0 = u0 / torch.clamp(_norm(u0), min=1e-30)
    u1 = u1 - torch.sum(u1 * u0, dim=-1, keepdim=True) * u0
    u1 = u1 / torch.clamp(_norm(u1), min=1e-30)
    u2 = torch.linalg.cross(u0, u1, dim=-1)
    # Sign of u2 so that M ~ U S Vᵀ holds for full-rank M (s2 > 0).
    mv2 = mv[..., :, 2]
    sgn = torch.where(torch.sum(mv2 * u2, dim=-1, keepdim=True) < 0.0, -1.0, 1.0)
    use_m = s[..., 2:3] > 1e-12 * torch.clamp(s[..., 0:1], min=1e-30)
    u2 = torch.where(use_m, u2 * sgn, u2)
    u = torch.stack([u0, u1, u2], dim=-1)
    return u, s, v.transpose(-1, -2)


def solve2x2(a: torch.Tensor, b: torch.Tensor, fallback: float = 0.0) -> torch.Tensor:
    """Cramer solve of (..., 2, 2) @ x = (..., 2); singular -> ``fallback``."""
    d = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    x0 = b[..., 0] * a[..., 1, 1] - a[..., 0, 1] * b[..., 1]
    x1 = a[..., 0, 0] * b[..., 1] - b[..., 0] * a[..., 1, 0]
    safe = torch.abs(d) > 1e-30
    x = torch.stack([x0, x1], -1)
    return torch.where(
        safe[..., None], x / torch.where(safe, d, torch.ones_like(d))[..., None],
        torch.full_like(x, fallback),
    )
