# Frozen copy of the port's plain ``ofps_torch/ops/five_point.py`` (the benchmark's
# reference; it imports nothing of the port).
"""Nistér 5-point minimal essential-matrix solver as a hidden-variable
resultant, batched (port of ``ofps_tpu.ops.five_point``).

1. The 4-dim null space of the 5x9 epipolar design matrix gives
   ``E(x, y, z) = x E1 + y E2 + z E3 + E4``.
2. The 10 cubic constraints (``det E = 0`` and ``2 E Eᵀ E - tr(E Eᵀ) E =
   0``) are evaluated at 20 fixed (x, y, z) probe points and mapped to
   their 10 x 20 monomial coefficients by a precomputed inverse.
3. Gauss-Jordan with partial pivoting eliminates the 10 leading monomials;
   differencing three row pairs gives a 3x3 polynomial matrix B(z)
   (degrees <= 4) with ``B(z) [x, y, 1]ᵀ = 0``.
4. ``P(θ) = cos¹⁰θ det B(tanθ)`` at 11 tan-angle nodes gives its
   even-harmonic trig interpolant; real roots come from sign changes on a
   512-point θ grid, 20 bisection steps and 3 Newton steps, plus 4 seeds
   at the deepest local minima of |P| for tangent roots.
5. For each root, (x, y) solves ``B(z*)[:, :2] [x, y] = -B(z*)[:, 2]`` by
   its 2x2 normal equations.

Two charts of the null space (the basis, and the basis mixed by a fixed
4x4 Hadamard) run as one batch and pool their candidates: 28 per sample.
The numpy constants are the JAX package's; their device copies are cached
per device, so a call captured in a CUDA graph copies nothing from the
host (the capture's eager warm-up call fills the cache).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ofps_bench.reference.epipolar import epipolar_rows, gram, project_to_essential
from ofps_bench.reference.solve import (
    _eye,
    det3,
    gauss_solve_pivoted,
    smallest_eigvecs_inverse_iteration,
)

# Trivariate monomials of total degree <= 3, split as the elimination needs:
#   eliminated (first 10): x³, y³, x²y, xy², x²z, x², y²z, y², xyz, xy
#   kept (last 10):        xz², xz, x, yz², yz, y, z³, z², z, 1


def _monomials20(x, y, z):
    one = np.ones_like(x)
    return np.stack(
        [
            x**3, y**3, x**2 * y, x * y**2, x**2 * z, x**2, y**2 * z,
            y**2, x * y * z, x * y,
            x * z**2, x * z, x, y * z**2, y * z, y, z**3, z**2, z, one,
        ],
        axis=0,
    )  # (20, npts)


# 20 (x, y, z) probe points (float64, cond(V20) = 10.5).
_P20 = np.array(
    [
        [-0.32762963, 0.80959387, 0.58612268, 0.36886925, -0.52225745,
         1.55036472, 0.60530217, -0.74912229, 0.64348662, -0.06436296,
         -0.20600484, 1.03263808, -0.80564053, -0.95859189, -1.08927787,
         -1.29945443, -0.05803361, 0.94307901, -0.83606385, -0.07729247],
        [-1.29930121, -0.85250692, 1.37247137, 0.57841958, 1.06650513,
         -0.77947526, 1.05330674, 1.27162516, -0.70786724, -0.44475738,
         -0.50372016, 0.07134761, 0.59043603, -1.39250342, 0.1881813,
         -0.68484683, 0.47519423, -0.17462412, 0.41217525, -0.62379822],
        [-0.12656579, -0.48921231, 1.14796693, 0.82383632, 0.85405468,
         -0.36732824, 0.10478399, -0.74018601, 0.96931083, 1.34876192,
         0.39251301, -0.39815935, -0.25767543, 0.85929289, 0.70142349,
         -0.12976881, -0.91062743, -1.41849298, -1.24034761, -1.02775763],
    ],
    np.float64,
)
_V20_INV = np.asarray(np.linalg.inv(_monomials20(*_P20)), np.float32)

# Tan-angle nodes over one period of the π-periodic P(θ).
_TH = ((2.0 * np.arange(11) + 1.0) / 22.0 - 0.5) * np.pi


def _trig_basis_np(theta):
    cols = [np.ones_like(theta)]
    for h in (2, 4, 6, 8, 10):
        cols += [np.cos(h * theta), np.sin(h * theta)]
    return np.stack(cols, axis=-1)  # (..., 11)


_TRIG_INV = np.asarray(np.linalg.inv(_trig_basis_np(_TH)), np.float32)
# B(z)'s entries at the nodes in homogenized form, cos⁴θ B(tanθ) =
# Σₖ bₖ sinᵏθ cos⁴⁻ᵏθ; det of that is cos¹²θ det B, so P = det / cos²θ.
_SC4_N = np.asarray(
    np.stack([np.sin(_TH) ** k * np.cos(_TH) ** (4 - k) for k in range(5)], axis=-1),
    np.float32,
)  # (11 nodes, 5 z-coefs)
_COS2_N = np.asarray(np.cos(_TH) ** 2, np.float32)

_N_GRID = 512  # tan-angle sign-scan resolution
_GRID_TH = np.linspace(-np.pi / 2 * 0.999, np.pi / 2 * 0.999, _N_GRID)
_GRID_B = np.asarray(_trig_basis_np(_GRID_TH), np.float32)  # (G, 11)
_GRID_THJ = np.asarray(_GRID_TH, np.float32)
_HADAMARD4 = np.asarray(
    0.5 * np.array([[1, 1, 1, 1], [1, -1, 1, -1], [1, 1, -1, -1], [1, -1, -1, 1]], np.float64),
    np.float32,
)
_MAX_ROOTS = 10
_EXTRA_SEEDS = 4


class _Consts:
    def __init__(self, device: str):
        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        self.px, self.py, self.pz = (t(np.asarray(c, np.float32)) for c in _P20)
        self.v20_inv = t(_V20_INV)
        self.trig_inv = t(_TRIG_INV)
        self.sc4_n = t(_SC4_N)
        self.cos2_n = t(_COS2_N)
        self.grid_bt = t(_GRID_B.T)
        self.grid_th = t(_GRID_THJ)
        self.hadamard4 = t(_HADAMARD4)
        self.ramp = t(np.arange(_N_GRID - 1, dtype=np.float32) / np.float32(_N_GRID))


@functools.lru_cache(maxsize=8)
def _consts(device: str) -> _Consts:
    return _Consts(device)


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last dim in ``jax.lax.top_k``'s
    order: descending, the lower index first among ties."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _constraints(e: torch.Tensor) -> torch.Tensor:
    """The 10 cubic constraints of (..., 3, 3): (..., 10), [det; flat(2 E
    Eᵀ E - tr(E Eᵀ) E)]."""
    eet = torch.matmul(e, e.transpose(-1, -2))
    tr = eet[..., 0, 0] + eet[..., 1, 1] + eet[..., 2, 2]
    m = 2.0 * torch.matmul(eet, e) - tr[..., None, None] * e
    return torch.cat([det3(e)[..., None], m.reshape(m.shape[:-2] + (9,))], dim=-1)


def _reduced_bpoly(basis: torch.Tensor, c: _Consts) -> torch.Tensor:
    """B(z) coefficients (..., 3, 3, 5) of null-space bases (..., 4, 3, 3).
    Degenerate eliminations give non-finite coefficients for the caller's
    validity gates (the other chart covers those samples)."""
    e1, e2, e3, e4 = (basis[..., k, None, :, :] for k in range(4))
    e = (c.px[:, None, None] * e1 + c.py[:, None, None] * e2
         + c.pz[:, None, None] * e3 + e4)  # (..., 20 points, 3, 3)
    coef = torch.matmul(_constraints(e).transpose(-1, -2), c.v20_inv)  # (..., 10, 20)
    t = gauss_solve_pivoted(coef[..., :10], coef[..., 10:])  # (..., 10, 10)
    # Row pairs (x²z, x²), (y²z, y²), (xyz, xy): eq(m z) - z eq(m) cancels
    # the eliminated monomial, leaving t_a - z t_b over the kept block.
    ta = t[..., 4:10:2, :]  # (..., 3, 10)
    tb = t[..., 5:10:2, :]
    zero = torch.zeros_like(ta[..., 0])

    def zcol(i0):  # kept triplet [m z², m z, m] -> degree-3 polynomial
        return torch.stack([
            ta[..., i0 + 2], ta[..., i0 + 1] - tb[..., i0 + 2],
            ta[..., i0] - tb[..., i0 + 1], -tb[..., i0], zero,
        ], dim=-1)

    col1 = torch.stack([  # kept quadruplet [z³, z², z, 1] -> degree 4
        ta[..., 9], ta[..., 8] - tb[..., 9], ta[..., 7] - tb[..., 8],
        ta[..., 6] - tb[..., 7], -tb[..., 6],
    ], dim=-1)
    bp = torch.stack([zcol(0), zcol(3), col1], dim=-2)  # (..., 3 rows, 3 cols, 5)
    # det B is used only up to scale: keep ill-conditioned eliminations in
    # float32 range.
    mag = torch.amax(torch.abs(bp), dim=(-3, -2, -1), keepdim=True)
    return bp / torch.clamp(mag, min=1e-30)


def _trig_eval(coefs: torch.Tensor, theta: torch.Tensor, want_grad: bool = False):
    """P(θ) (and dP/dθ) in the basis [1, cos2θ, sin2θ, ..., cos10θ,
    sin10θ]: ``coefs`` (..., 11), ``theta`` (..., R); the harmonics by the
    double-angle recurrence."""
    c2 = torch.cos(2.0 * theta)
    s2 = torch.sin(2.0 * theta)
    acc = coefs[..., 0, None].expand(theta.shape)
    grad = torch.zeros_like(theta) if want_grad else None
    ck, sk = c2, s2
    for i in range(1, 6):
        ac = coefs[..., 2 * i - 1, None]
        as_ = coefs[..., 2 * i, None]
        acc = acc + ac * ck + as_ * sk
        if want_grad:
            grad = grad + 2.0 * i * (as_ * ck - ac * sk)
        if i < 5:
            ck, sk = ck * c2 - sk * s2, sk * c2 + ck * s2
    return (acc, grad) if want_grad else acc


def _tangent_seeds(pv: torch.Tensor) -> torch.Tensor:
    """Grid indices (minus one) of the _EXTRA_SEEDS deepest local minima of
    |P| on the grid (..., G): tangent (double) roots make no sign change.
    Every other point scores -inf, so when there are fewer minima the
    ties keep index order, as in ``jax.lax.top_k``."""
    absp = torch.abs(pv)
    mid_p = absp[..., 1:-1]
    locmin = (mid_p <= absp[..., :-2]) & (mid_p <= absp[..., 2:])
    mscore = torch.where(locmin, -mid_p, torch.full_like(mid_p, -torch.inf))
    return _top_k(mscore, _EXTRA_SEEDS)


def _solve_chart(basis: torch.Tensor, c: _Consts):
    """Essential candidates (..., 14, 3, 3) and validity (..., 14) of null
    space bases (..., 4, 3, 3)."""
    bp = _reduced_bpoly(basis, c)
    bt = torch.sum(bp[..., None, :, :, :] * c.sc4_n[:, None, None, :], dim=-1)  # (..., 11, 3, 3)
    p = det3(bt) / c.cos2_n
    scale = torch.clamp(torch.amax(torch.abs(p), dim=-1), min=1e-30)[..., None]
    coefs = torch.sum(c.trig_inv * (p / scale)[..., None, :], dim=-1)  # (..., 11)

    # Real roots: sign scan over θ, then bisection on P.
    pv = torch.matmul(coefs, c.grid_bt)  # (..., G)
    sgn = torch.sign(pv)
    change = (sgn[..., :-1] * sgn[..., 1:]) < 0.0
    # Up to _MAX_ROOTS bracketed intervals, earliest first.
    idx = _top_k(change.to(torch.float32) * 2.0 - c.ramp, _MAX_ROOTS)
    bracketed = torch.gather(change, -1, idx)
    lo = c.grid_th[idx]
    hi = c.grid_th[idx + 1]
    flo = _trig_eval(coefs, lo)
    for _ in range(20):
        mid = 0.5 * (lo + hi)
        fmid = _trig_eval(coefs, mid)
        same = torch.sign(fmid) == torch.sign(flo)
        lo = torch.where(same, mid, lo)
        flo = torch.where(same, fmid, flo)
        hi = torch.where(same, hi, mid)
    th = 0.5 * (lo + hi)

    midx = _tangent_seeds(pv)
    th = torch.cat([th, c.grid_th[midx + 1]], dim=-1)
    bracketed = torch.cat([bracketed, torch.ones_like(midx, dtype=torch.bool)], dim=-1)

    # Newton polish on the interpolant.
    for _ in range(3):
        f0, fp = _trig_eval(coefs, th, want_grad=True)
        step = f0 / torch.where(torch.abs(fp) > 1e-20, fp, torch.full_like(fp, 1e-20))
        th = th - torch.clamp(step, -0.02, 0.02)

    # Residual gate: genuine roots have |P(θ)| ~ 0 after polishing.
    valid = bracketed & (torch.abs(_trig_eval(coefs, th)) < 1e-3)
    z = torch.tan(th)

    # (x, y) from the homogenized B(z*) [x, y, 1]ᵀ = 0 by 2x2 normal equations.
    s, cth = torch.sin(th), torch.cos(th)
    sc = torch.stack([s**k * cth ** (4 - k) for k in range(5)], dim=-1)  # (..., R, 5)
    b3 = torch.sum(bp[..., None, :, :, :] * sc[..., :, None, None, :], dim=-1)  # (..., R, 3, 3)
    a2 = b3[..., :, :2]
    b2 = -b3[..., :, 2]
    g = gram(a2, a2)  # (..., R, 2, 2)
    tr2 = g[..., 0, 0] + g[..., 1, 1]
    g = g + (1e-10 * tr2)[..., None, None] * _eye(2, str(g.device))
    gb = torch.sum(a2 * b2[..., None], dim=-2)
    d2 = g[..., 0, 0] * g[..., 1, 1] - g[..., 0, 1] * g[..., 1, 0]
    d2s = torch.where(torch.abs(d2) > 1e-30, d2, torch.full_like(d2, 1e-30))
    x = (g[..., 1, 1] * gb[..., 0] - g[..., 0, 1] * gb[..., 1]) / d2s
    y = (g[..., 0, 0] * gb[..., 1] - g[..., 1, 0] * gb[..., 0]) / d2s
    ok_denom = (torch.isfinite(x) & torch.isfinite(y)
                & (torch.maximum(torch.abs(x), torch.abs(y)) < 1e6))

    e1, e2, e3, e4 = (basis[..., k, None, :, :] for k in range(4))
    es = (x[..., None, None] * e1 + y[..., None, None] * e2
          + z[..., None, None] * e3 + e4)
    es = project_to_essential(es)
    norm = torch.sqrt(torch.sum(es * es, dim=(-2, -1)))
    es = es / torch.clamp(norm, min=1e-20)[..., None, None]
    # A zero candidate (the analytic SVD's squared terms overflow on
    # entries near 1e6 and it returns zero factors) has no Sampson error
    # anywhere and would win every vote: it is not valid.  The JAX package
    # lacks this gate (tests/test_torch_five_point.py).
    valid = valid & ok_denom & torch.isfinite(es).flatten(-2).all(-1) & (norm > 1e-20)
    return es, valid


def five_point_essential(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor):
    """Essential candidates of (weighted) 5-point samples: x1, x2 (..., 5,
    2) normalized camera coordinates, w (..., 5).  Returns (es (..., 28, 3,
    3), valid (..., 28)): two charts of up to 10 bracketed roots and 4
    tangent seeds each, the multi-model shape ``robust_fit`` takes."""
    c = _consts(str(x1.device))
    rows = epipolar_rows(x1, x2) * w[..., None]
    nullb = smallest_eigvecs_inverse_iteration(gram(rows, rows), k=4, iters=4)  # (..., 9, 4)
    basis = nullb.transpose(-1, -2)  # (..., 4, 9): E1..E4 flattened
    mixed = torch.sum(c.hadamard4[:, :, None] * basis[..., None, :, :], dim=-2)
    charts = torch.stack([basis, mixed], dim=-3)
    es, valid = _solve_chart(charts.reshape(charts.shape[:-1] + (3, 3)), c)
    lead = es.shape[:-4]
    return es.reshape(lead + (-1, 3, 3)), valid.reshape(lead + (-1,))
