"""Parity of the port's homography stack with ofps_tpu on the CPU.

Covered: ``ops/solve`` (every function), ``_masked_median`` (bit-exact),
``ransac_budget`` (exact), ``ops/homography`` (DLT, transfer error,
Gauss-Newton, decomposition), ``robust_fit`` in each of its modes with the
JAX draws injected, and the registered estimator.

Fields are 150 x 84 lattices (the serving grid) seen through a homography,
with 1e-4 of noise and 20% gross outliers (uniform over the frame), so
that every inlier sits ~10 sigma inside the 1e-3 cut and membership has
clear margins.  Tolerances: solve within 1e-5 relative (float32 formulas
repeated in another reduction order); the median bit-exact; homographies
within 1e-4 relative after normalising h22 (long weighted sums in another
order, then 9 eliminations); transfer residuals within a few float32 ulps
of a unit coordinate; the same winning hypothesis and the same inlier
mask; quaternions within 1e-4 (family by family where the decomposition's
two families tie, see ``test_estimator_matches_jax_and_batches``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofps_torch import interop
from ofps_torch.core import quat as tq
from ofps_torch.core.camera import StandardCamera as TCam
from ofps_torch.core.motion import SparseFlow as TSparse
from ofps_torch.estimators import homography as the
from ofps_torch.estimators.base import create_estimator as t_est
from ofps_torch.ops import homography as tho
from ofps_torch.ops import robust as trob
from ofps_torch.ops import solve as tsolve
from ofps_tpu.core import quat as jq
from ofps_tpu.core.camera import StandardCamera as JCam
from ofps_tpu.core.motion import SparseFlow as JSparse
from ofps_tpu.core.motion import field_to_sparse
from ofps_tpu.estimators import homography as jhe
from ofps_tpu.ops import homography as jho
from ofps_tpu.ops import robust as jrob
from ofps_tpu.ops import solve as jsolve

GW, GH = 150, 84
N = GW * GH
JCAM = JCam.create(GW / GH, 60.0)
TCAM = TCam.create(GW / GH, 60.0)
H_COUNT = jrob.ransac_budget(0.997, 0.5, 4, 512)  # 91


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.asarray(x).dtype))


def _rel(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _h22(h):
    h = np.asarray(h)
    return h / h[..., 2:3, 2:3]


# -- ops/solve ---------------------------------------------------------------


def _spd(rng, b, n):
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)).astype(np.float32)


def _solve_cases():
    rng = np.random.default_rng(0)
    a3 = rng.normal(size=(32, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    b3 = rng.normal(size=(32, 3)).astype(np.float32)
    a9, b9 = _spd(rng, 32, 9), rng.normal(size=(32, 9, 2)).astype(np.float32)
    # General (non-symmetric) and row-permuted, so that pivoting swaps rows.
    perm = np.stack([np.eye(9, dtype=np.float32)[rng.permutation(9)] for _ in range(32)])
    gen9 = perm @ (0.3 * rng.normal(size=(32, 9, 9)) + 3 * np.eye(9)).astype(np.float32)
    a2 = rng.normal(size=(32, 2, 2)).astype(np.float32) + 2 * np.eye(2, dtype=np.float32)
    # 8 near-orthonormal rows: a 1-D null space, the other eigenvalues ~1.
    rows = np.linalg.qr(rng.normal(size=(32, 9, 9)))[0][:, :8].astype(np.float32)
    rows += 0.05 * rng.normal(size=rows.shape).astype(np.float32)
    return {
        "det3": ((a3,), {}),
        "solve3x3": ((a3, b3), {}),
        "gauss_solve": ((a9, b9), {}),
        "gauss_solve_pivoted": ((gen9, b9), {}),
        "gauss_inverse": ((a9,), {}),
        "inv3x3": ((a3,), {}),
        "smallest_eigvecs_inverse_iteration": ((rows.transpose(0, 2, 1) @ rows,), {"k": 1}),
        "solve2x2": ((a2, b3[:, :2]), {}),
    }


@pytest.mark.parametrize("name", list(_solve_cases()))
def test_solve_matches(name):
    args, kw = _solve_cases()[name]
    ref = np.asarray(jax.jit(getattr(jsolve, name), static_argnames=tuple(kw))(*args, **kw))
    got = getattr(tsolve, name)(*map(_t, args), **kw).numpy()
    assert got.shape == ref.shape
    assert _rel(got, ref) <= 1e-5, _rel(got, ref)


def test_solve_singular_fallbacks():
    z3 = np.zeros((2, 3, 3), np.float32)
    for name, args in (("solve3x3", (z3, np.ones((2, 3), np.float32))),
                       ("inv3x3", (z3,)),
                       ("solve2x2", (z3[:, :2, :2], np.ones((2, 2), np.float32)))):
        ref = np.asarray(getattr(jsolve, name)(*map(jnp.asarray, args), fallback=7.0))
        got = getattr(tsolve, name)(*map(_t, args), fallback=7.0).numpy()
        np.testing.assert_array_equal(got, ref)


def _spectrum_cases(gap):
    """Symmetric PSD 3x3s with eigenvalues (1, 1 + gap, 3) in random bases."""
    rng = np.random.default_rng(1)
    q, _ = np.linalg.qr(rng.normal(size=(32, 3, 3)))
    lam = np.array([1.0, 1.0 + gap, 3.0])
    return (q @ (lam[:, None] * q.transpose(0, 2, 1))).astype(np.float32)


@pytest.mark.parametrize("gap", [1.0, 3e-2, 1e-2])
def test_eigh3x3_and_svd3x3_match(gap):
    """Eigenvalues and singular values within 1e-5 / sqrt(gap) relative;
    eigenvectors and singular vectors compared by |v . v_ref| (their sign
    is free), within 1e-6 / gap of 1.

    The analytic method's own error grows as the pair's gap shrinks (at a
    gap of 1e-2 both packages' singular values are 1.5e-5 from the exact
    ones, the same formulas on float32 inputs), so the parity tolerance
    follows it; below ~1e-3 neither package's vectors mean anything."""
    a = _spectrum_cases(gap)
    tol_val, tol_dot = 1e-5 / np.sqrt(gap), 1e-6 / gap
    vals_r, vecs_r = map(np.asarray, jax.jit(jsolve.eigh3x3)(a))
    vals, vecs = (x.numpy() for x in tsolve.eigh3x3(_t(a)))
    assert _rel(vals, vals_r) <= tol_val
    assert np.abs(np.sum(vecs * vecs_r, axis=-2)).min() >= 1.0 - tol_dot
    u_r, s_r, vt_r = map(np.asarray, jax.jit(jsolve.svd3x3)(a))
    u, s, vt = (x.numpy() for x in tsolve.svd3x3(_t(a)))
    assert _rel(s, s_r) <= tol_val
    assert np.abs(np.sum(u * u_r, axis=-2)).min() >= 1.0 - tol_dot
    assert np.abs(np.sum(vt * vt_r, axis=-1)).min() >= 1.0 - tol_dot


# -- _masked_median, ransac_budget ---------------------------------------------


def _bits(x):
    return np.frombuffer(np.uint32(x).tobytes(), np.float32)[0]


def _median_case(kind):
    rng = np.random.default_rng(2)
    err = rng.exponential(1e-6, size=(16, 64)).astype(np.float32)
    w = (rng.uniform(size=(64,)) > 0.3).astype(np.float32)
    if kind == "ties":
        err = np.round(err * 1e6).astype(np.float32) * np.float32(1e-6)
    elif kind == "nan":
        err[:, ::3] = np.nan
    elif kind == "neg_nan":
        err[:, ::3] = _bits(0xFFC00000)
        err[:8, 1::3] = _bits(0xFF800001)
    elif kind == "inf":
        err[:, ::2] = np.inf
        err[:4, 1::2] = -np.inf
    elif kind == "zeros":
        err[:, ::2] = 0.0
        err[:, 1::4] = -0.0
        err[:, 3::4] = -1e-6
    elif kind == "all_invalid":
        w = np.zeros((16, 64), np.float32)
        w[::2, 5] = 1.0  # every other row keeps one valid entry
    elif kind == "prescore":
        err = rng.exponential(1e-6, size=(2, H_COUNT, 128)).astype(np.float32)
        err[0, :, ::7] = 1e-3
        w = np.ones((2, 1, 128), np.float32)
        w[1, 0, ::3] = 0.0
    return err, w


@pytest.mark.parametrize(
    "kind", ["plain", "ties", "nan", "neg_nan", "inf", "zeros", "all_invalid", "prescore"])
def test_masked_median_bit_exact(kind):
    err, w = _median_case(kind)
    # JAX's takes one weight vector per call: vmap it over the streams/rows.
    if kind == "prescore":
        ref = jax.jit(jax.vmap(jrob._masked_median))(err, w[:, 0])
    elif w.ndim == 1:
        ref = jax.jit(jrob._masked_median)(err, w)
    else:
        ref = jax.jit(jax.vmap(lambda e, x: jrob._masked_median(e[None], x)[0]))(err, w)
    ref = np.asarray(ref)
    got = trob.masked_median(_t(err), _t(w)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_ransac_budget_exact():
    for conf in (0.9, 0.99, 0.997, 0.9999):
        for eps in (0.0, 0.1, 0.3, 0.5, 0.7, 0.95):
            for k in (3, 4, 5, 7, 8):
                for cap in (8, 91, 512, 2000):
                    assert trob.ransac_budget(conf, eps, k, cap) == jrob.ransac_budget(
                        conf, eps, k, cap)


# -- ops/homography ----------------------------------------------------------

H_TRUE = np.array([[1.01, 0.02, 0.012], [-0.015, 0.99, -0.008], [0.03, -0.02, 1.0]],
                  np.float32)


def _homography_field(seed, h=H_TRUE, noise=1e-4, outliers=0.2, invalid=0.0):
    """(x1, x2, w) on the 150 x 84 lattice: x2 = H x1 + noise, a share of
    gross outliers uniform over the frame, a share of invalid points."""
    rng = np.random.default_rng(seed)
    x1 = np.asarray(field_to_sparse(jnp.zeros((GH, GW, 2), jnp.float32)).pos)
    p = np.c_[x1, np.ones(len(x1), np.float32)] @ h.T
    x2 = (p[:, :2] / p[:, 2:]).astype(np.float32)
    x2 += rng.normal(0, noise, x2.shape).astype(np.float32)
    bad = rng.uniform(size=len(x1)) < outliers
    x2[bad] = rng.uniform(0, 1, (bad.sum(), 2)).astype(np.float32)
    w = (rng.uniform(size=len(x1)) >= invalid).astype(np.float32)
    return x1.astype(np.float32), x2, w


_j_dlt = jax.jit(jho.dlt_homography)
_j_gn = jax.jit(jho.gn_refine_homography)
_j_err = jax.jit(jho.homography_transfer_error)


@pytest.mark.parametrize("size", ["minimal", "weighted"])
def test_dlt_error_and_gn_match(size):
    x1, x2, w = _homography_field(3, outliers=0.0)
    rng = np.random.default_rng(4)
    if size == "minimal":
        pick = rng.choice(len(x1), 4, replace=False)
        x1, x2, w = x1[pick], x2[pick], w[pick]
    else:
        pick = rng.choice(len(x1), 2000, replace=False)
        x1, x2 = x1[pick], x2[pick]
        w = rng.uniform(0.2, 1.0, 2000).astype(np.float32)
    ref = np.asarray(_j_dlt(x1, x2, w))
    got = tho.dlt_homography(_t(x1), _t(x2), _t(w)).numpy()
    assert _rel(_h22(got), _h22(ref)) <= 1e-4
    h0 = H_TRUE * np.float32(1.002)  # a start off the optimum
    ref_e = np.asarray(_j_err(jnp.asarray(h0), x1, x2))
    got_e = tho.homography_transfer_error(_t(h0), _t(x1), _t(x2)).numpy()
    # A squared residual of ~1e-8 is a difference of two ~0.5 coordinates:
    # the residual lengths agree within a few float32 ulps of 1 (both are
    # ~1e-10 from the float64 value in squared terms).
    assert np.abs(np.sqrt(got_e) - np.sqrt(ref_e)).max() <= 4e-7
    ref_g = np.asarray(_j_gn(jnp.asarray(h0), x1, x2, w))
    got_g = tho.gn_refine_homography(_t(h0), _t(x1), _t(x2), _t(w)).numpy()
    assert _rel(_h22(got_g), _h22(ref_g)) <= 1e-4


@pytest.mark.parametrize("case", ["translating_plane", "pure_rotation"])
def test_decompose_homography_matches(case):
    k = np.asarray(JCAM.intrinsics())
    if case == "pure_rotation":  # H = K R K^-1: the degenerate branch
        r = np.asarray(jq.to_matrix3(jq.from_euler(0.004, -0.007, 0.003)))
        h = k @ r @ np.linalg.inv(k)
    else:  # R + t n^T with a clear translation
        r = np.asarray(jq.to_matrix3(jq.from_euler(0.01, 0.02, -0.015)))
        h = k @ (r + np.outer([0.05, -0.02, 0.03], [0.1, 0.2, 0.97])) @ np.linalg.inv(k)
    h = (h / h[2, 2]).astype(np.float32)
    rs_r, ts_r, ns_r = map(np.asarray, jax.jit(jho.decompose_homography)(h, k))
    rs, ts, ns = (x.numpy() for x in tho.decompose_homography(_t(h), TCAM.intrinsics()))
    np.testing.assert_allclose(rs, rs_r, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts, ts_r, rtol=0, atol=1e-5)
    if case == "pure_rotation":
        np.testing.assert_allclose(rs[0], r, rtol=0, atol=1e-5)
        assert np.array_equal(ts, np.zeros_like(ts))
    else:
        np.testing.assert_allclose(ns, ns_r, rtol=0, atol=1e-5)


def test_camera_intrinsics_and_from_matrix3_match():
    # fx and fy within one float32 ulp (tan and deg2rad of either library).
    np.testing.assert_allclose(TCAM.intrinsics().numpy(), np.asarray(JCAM.intrinsics()),
                               rtol=2.4e-7, atol=0)
    rng = np.random.default_rng(5)
    qs = rng.normal(size=(64, 4)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    r = np.asarray(jq.to_matrix3(jnp.asarray(qs)))  # every Shepperd case
    np.testing.assert_allclose(tq.from_matrix3(_t(r)).numpy(),
                               np.asarray(jq.from_matrix3(jnp.asarray(r))), rtol=0, atol=1e-6)


# -- robust_fit --------------------------------------------------------------

MODES = {
    "dense_ransac": dict(dense=True),
    "masked_ransac": dict(dense=False),
    "lmeds": dict(dense=True, use_lmeds=True),
    "cauchy": dict(dense=True, refit_weight="cauchy"),
}


def _fit_kwargs(mode, ops, refit=True):
    kw = dict(
        minimal_fit=(
            (lambda a, b, c: (ops.dlt_homography(a, b, c)[None], jnp.ones((1,), bool)))
            if ops is jho else
            (lambda a, b, c: (ops.dlt_homography(a, b, c)[..., None, :, :],
                              torch.ones(a.shape[:-2] + (1,), dtype=torch.bool)))),
        sample_size=4, error_fn=ops.homography_transfer_error, num_hypotheses=H_COUNT,
        threshold=0.001, eval_cap=2048, adaptive_threshold=True,
        refit_fn=ops.dlt_homography if refit else None, prescore_cap=128, finalists=32,
    )
    kw.update(MODES[mode])
    return kw


def _jax_fit(mode, key, x1, x2, w):
    """JAX's result, and its winning hypothesis: the minimal model (of the
    same draws) nearest the result of the same fit without LO refits."""
    idx = jrob.sample_indices(key, w, H_COUNT, 4, dense=MODES[mode]["dense"])
    full = jrob.robust_fit(key, x1, x2, w, **_fit_kwargs(mode, jho))
    bare = jrob.robust_fit(key, x1, x2, w, **_fit_kwargs(mode, jho, refit=False))
    models = jax.vmap(lambda i: jho.dlt_homography(x1[i], x2[i], w[i]))(idx)
    best = jnp.argmin(jnp.sum((models - bare.model) ** 2, axis=(-2, -1)))
    return full, best, idx


@pytest.mark.parametrize("mode", list(MODES))
def test_robust_fit_matches_with_injected_draws(mode):
    x1, x2, w = _homography_field(6, invalid=1 / 3 if mode == "masked_ransac" else 0.0)
    key = jax.random.PRNGKey(7)
    ref, ref_best, idx = jax.jit(_jax_fit, static_argnums=0)(mode, key, x1, x2, w)
    got = trob.robust_fit(_t(x1), _t(x2), _t(w), idx=_t(idx), **_fit_kwargs(mode, tho))
    assert int(got.best) == int(ref_best)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert 0.7 * len(x1) * w.mean() < got.inliers.sum() < 0.9 * len(x1) * w.mean()
    assert _rel(_h22(got.model.numpy()), _h22(ref.model)) <= 1e-4
    # RANSAC scores are inlier counts; the LMedS score is a median squared
    # residual of ~1e-8, a difference of two ~0.5 coordinates squared, so
    # it carries ~1e-3 of relative rounding.
    np.testing.assert_allclose(got.score.numpy(), np.asarray(ref.score),
                               rtol=1e-2 if mode == "lmeds" else 0)


def test_masked_sampler_and_eval_subset_draw_valid_points():
    """The masked sampler draws only valid points, stream by stream, and
    the runtime eval subset equals the JAX package's compaction."""
    w = (np.random.default_rng(8).uniform(size=(2, N)) > 1 / 3).astype(np.float32)
    idx = trob.sample_indices(torch.Generator().manual_seed(0), N, 500, 4, w=_t(w))
    assert idx.shape == (2, 500, 4)
    for b in range(2):
        assert (w[b][idx[b].numpy()] == 1.0).all()
    eidx, we = trob.eval_subset(_t(w), 2048)
    for b in range(2):
        wc = jrob.uniform_cap_weights(jnp.asarray(w[b]), 2048)
        cw = jnp.cumsum((wc > 0.5).astype(jnp.int32))
        ref = jnp.minimum(jnp.searchsorted(cw, jnp.arange(1, 2049), side="left"), N - 1)
        np.testing.assert_array_equal(eidx[b].numpy(), np.asarray(ref))
        np.testing.assert_array_equal(we[b].numpy(), np.asarray(wc[ref]))


# -- the estimator -------------------------------------------------------------


def _rotation_flow(seed, noise=2e-6, outliers=0.2):
    """(pos, motion, mask): a camera rotation on the serving lattice."""
    rng = np.random.default_rng(seed)
    lattice = field_to_sparse(jnp.zeros((GH, GW, 2), jnp.float32))
    q = jq.from_euler(*(rng.uniform(-0.01, 0.01, 3).astype(np.float32)))
    mot = np.array(JCAM.delta(lattice.pos, jq.to_matrix4(q)))
    mot += rng.normal(0, noise, mot.shape).astype(np.float32)
    bad = rng.uniform(size=len(mot)) < outliers
    mot[bad] = rng.normal(0, 0.01, (bad.sum(), 2)).astype(np.float32)
    return np.asarray(lattice.pos), mot.astype(np.float32), np.ones(len(mot), np.float32)


@jax.jit
def _j_estimate(key, pos, mot, mask):
    est = jhe.make_homography()
    return est.estimate((), JSparse(pos, mot, mask), JCAM, key, dense=True)[0]


def _candidates(est, flow, idx):
    """The port's two family rotations (..., 2, 4) and squared |t| (..., 2)
    of the refined homography of ``flow`` with draws ``idx``."""
    h = the.refined_homography(None, est.params, flow, TCAM, dense=True, fit_idx=idx)
    return the.rotation_candidates(h, TCAM)


@pytest.mark.parametrize("field", ["rotation", "plane"])
def test_estimator_matches_jax_and_batches(field):
    """The registered estimator against JAX's on the same draws.

    On the exact homography of a camera rotation, K R K^-1 (no noise, 20%
    outliers), the fit takes the pure-rotation branch, both decomposition families are the
    same rotation, and the quaternions agree within 1e-4.  On a
    translating plane the two families have equal |t| in exact
    arithmetic, so which one the minimum picks is decided by rounding in
    either package (and in a batched call against a single one): there
    JAX's result must be within 1e-4 of one of the port's two family
    rotations and the port's result is the one its own minimum picks.  B=2
    in one call gives each stream's candidates within 1e-6 of the single
    calls' (the same float32 work in another reduction order)."""
    k = np.asarray(JCAM.intrinsics())
    rot = [k @ np.asarray(jq.to_matrix3(jq.from_euler(*e))) @ np.linalg.inv(k)
           for e in ((0.004, -0.007, 0.003), (-0.006, 0.002, 0.005))]
    hs = [(h / h[2, 2]).astype(np.float32) for h in rot] if field == "rotation" else [
        H_TRUE, H_TRUE.T]
    flows = []
    for s, h in zip((11, 12), hs):
        x1, x2, w = _homography_field(s, h=h, noise=0.0 if field == "rotation" else 1e-4)
        flows.append((x1, x2 - x1, w))
    keys = jax.random.split(jax.random.PRNGKey(13), 2)
    est = t_est("homography")
    singles = []
    for (pos, mot, mask), key in zip(flows, keys):
        ref = np.asarray(_j_estimate(key, pos, mot, mask))
        idx = _t(jrob.sample_indices(key, jnp.asarray(mask), H_COUNT, 4, dense=True))
        flow = TSparse(_t(pos), _t(mot), _t(mask))
        r, t, st = est.estimate((), flow, TCAM, dense=True, fit_idx=idx)
        assert st == () and torch.equal(t, torch.zeros(3))
        quats, tnorm = _candidates(est, flow, idx)
        assert torch.equal(r, quats[int(torch.argmin(tnorm))])
        if field == "rotation":
            assert torch.equal(quats[0], quats[1])
            np.testing.assert_allclose(r.numpy(), ref, rtol=0, atol=1e-4)
        else:
            assert (quats[0] - quats[1]).abs().max() > 1e-3  # two distinct answers
            assert np.abs(quats.numpy() - ref).max(-1).min() <= 1e-4
        singles.append((quats, idx))
    both = TSparse(*(torch.stack([_t(f[i]) for f in flows]) for i in range(3)))
    idx2 = torch.stack([i for _, i in singles])
    r2, _, _ = est.estimate((), both, TCAM, dense=True, fit_idx=idx2)
    quats2, tnorm2 = _candidates(est, both, idx2)
    torch.testing.assert_close(quats2, torch.stack([q for q, _ in singles]), rtol=0, atol=1e-6)
    pick = torch.argmin(tnorm2, dim=-1)
    assert torch.equal(r2, quats2[torch.arange(2), pick])


def test_estimator_degenerate_input_gives_identity():
    pos, mot, _ = _rotation_flow(14)
    mask = np.zeros(len(pos), np.float32)
    mask[:3] = 1.0  # fewer valid points than a minimal sample
    r, _, _ = t_est("homography").estimate((), TSparse(_t(pos), _t(mot), _t(mask)), TCAM)
    np.testing.assert_array_equal(r.numpy(), np.array([1.0, 0.0, 0.0, 0.0], np.float32))


def test_estimator_registry_props_and_interop():
    from ofps_tpu.estimators.homography import HomographyParams as JParams

    est = t_est("homography", max_error=0.002)
    assert est.dyn_defaults() == {"max_error": 0.002}
    assert isinstance(est.dyn_defaults()["max_error"], float)
    assert est.draw(torch.Generator().manual_seed(0), (3,), N, "cpu").shape == (3, H_COUNT, 4)
    jp = JParams(max_error=0.004, finalists=16, use_ransac=False)
    tp = interop.homography_params_from_jax(jp)
    assert tp._asdict() == jp._asdict()
    assert interop.homography_params_from_jax(jhe.HomographyParams()) == type(tp)()
