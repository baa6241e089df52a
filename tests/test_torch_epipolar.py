"""Parity of the port's epipolar geometry (``ofps_torch.ops.epipolar``) and
the axis-angle quaternion helpers with ofps_tpu on the CPU.

Fixtures are seeded two-view scenes: points at depths 2-6 seen by a camera
that rotates 3-20 degrees and translates a unit step, in normalized camera
coordinates, batched over 4 scenes (the JAX functions are vmapped).

Tolerances: matrices within 1e-5 relative to their largest entry, up to
the sign of each matrix (a null vector or a singular vector has no sign),
for the 8- and 7-point fits, ``project_to_essential`` and
``decompose_essential`` (float32 formulas repeated in another reduction
order); Sampson errors within 1e-5 relative; the poses of
``recover_pose_from_essential``, ``refine_pose_sampson`` (on a fixture
where every step is decisive), ``rotation_only_fallback`` and
``motion_from_essential_and_correspondence`` within 2e-3 degrees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofps_torch.core import quat as tq
from ofps_torch.ops import epipolar as te
from ofps_tpu.core import quat as jq
from ofps_tpu.ops import epipolar as je

B = 4


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.asarray(x).dtype))


def _rotm(ax, ang):
    ax = ax / np.linalg.norm(ax)
    k = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    return np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * k @ k


def _scenes(seed, n=40, noise=0.0, max_deg=20.0):
    """(x1, x2) (B, n, 2) normalized coordinates, R (B, 3, 3), t (B, 3)."""
    rng = np.random.default_rng(seed)
    x1s, x2s, rs, ts = [], [], [], []
    for _ in range(B):
        r = _rotm(rng.normal(size=3), np.deg2rad(rng.uniform(3.0, max_deg)))
        t = rng.normal(size=3)
        t /= np.linalg.norm(t)
        x = rng.uniform(-1, 1, (n, 3))
        x[:, 2] = rng.uniform(2, 6, n)
        x2c = x @ r.T + t
        x1s.append(x[:, :2] / x[:, 2:3])
        x2s.append(x2c[:, :2] / x2c[:, 2:3] + rng.normal(0, noise, (n, 2)))
        rs.append(r)
        ts.append(t)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(x1s), f32(x2s), f32(rs), f32(ts)


def _rel_up_to_sign(got, ref):
    """Max over matrices of min(|got - ref|, |got + ref|) / max |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    axes = tuple(range(-2, 0))
    d = np.minimum(np.abs(got - ref).max(axes), np.abs(got + ref).max(axes))
    return float((d / np.abs(ref).max(axes)).max())


def _deg(ra, rb):
    """Angles (deg) between rotation matrices."""
    qa = tq.from_matrix3(_t(ra))
    qb = tq.from_matrix3(_t(rb))
    return np.degrees(tq.angle_to(qa, qb).numpy())


def test_eight_point_matches():
    x1, x2, _, _ = _scenes(0, noise=1e-3)
    w = np.ones(x1.shape[:2], np.float32)
    w[:, ::5] = 0.0  # weights mask some points
    ref = jax.jit(jax.vmap(je.eight_point_fundamental))(x1, x2, w)
    got = te.eight_point_fundamental(_t(x1), _t(x2), _t(w))
    assert got.shape == (B, 3, 3)
    assert _rel_up_to_sign(got, ref) <= 1e-5


def _matched(a, av, b, bv, tol):
    """Every valid matrix of ``a`` (S, M, 3, 3) has a valid one of ``b`` in
    the same sample within ``tol`` (Frobenius, up to sign)."""
    for s in range(a.shape[0]):
        for m in a[s][av[s]]:
            cand = b[s][bv[s]]
            d = np.minimum(np.sqrt(((cand - m) ** 2).sum((-2, -1))),
                           np.sqrt(((cand + m) ** 2).sum((-2, -1))))
            if not (d.size and d.min() <= tol):
                return False
    return True


def test_seven_point_matches():
    """A minimal 7-point sample has an exact 2-D null space, so the basis
    the inverse iteration returns inside it is set by float32 rounding, in
    either package, and with it the order of the cubic's roots: the two
    candidate sets are compared as sets (1e-3, Frobenius, up to sign), and
    the true F must be among each package's candidates."""
    x1, x2, r_true, t_true = _scenes(1, n=7)
    w = np.ones((B, 7), np.float32)
    ref_f, ref_v = jax.jit(jax.vmap(je.seven_point_fundamental))(x1, x2, w)
    got_f, got_v = te.seven_point_fundamental(_t(x1), _t(x2), _t(w))
    assert got_f.shape == (B, 3, 3, 3) and got_v.shape == (B, 3)
    ref_f, ref_v, got_f, got_v = map(np.asarray, (ref_f, ref_v, got_f, got_v))
    assert (ref_v.sum(-1) == got_v.sum(-1)).all()
    assert _matched(ref_f, ref_v, got_f, got_v, 1e-3) and _matched(got_f, got_v, ref_f, ref_v, 1e-3)
    f_true = _true_essential(r_true, t_true)  # normalized coordinates: F = E
    f_true /= np.linalg.norm(f_true, axis=(-2, -1), keepdims=True)
    one = np.ones((B, 1), bool)
    assert _matched(f_true[:, None], one, got_f, got_v, 1e-3)
    assert _matched(f_true[:, None], one, ref_f, ref_v, 1e-3)


# Seven points of the 84x150 serving lattice (positions in [0, 1]) that do
# not move, as float32 bit patterns: for x2 == x1 every skew-symmetric F
# fits, so the cubic det(F1 + l F2) vanishes identically and its leading
# coefficient rounds to exactly 0 here.
_STATIC7 = np.array([
    0x3f47ae14, 0x3e124925, 0x3f3f258c, 0x3d73cf3d, 0x3f222222, 0x3ea49249, 0x3f444444,
    0x3ddb6db7, 0x3ef258bf, 0x3df3cf3d, 0x3d75c28f, 0x3f3cf3cf, 0x3f1eb852, 0x3e124925,
], np.uint32).view(np.float32).reshape(7, 2)


def test_robust_fit_drops_nan_seven_point_candidate(monkeypatch):
    """A fault of the reference that the port does not keep: a 7-point
    sample whose cubic has a zero leading coefficient gives NaN roots,
    the first marked valid, in both packages' solvers.  JAX's
    ``robust_fit`` keeps that candidate: its NaN median makes the adaptive
    cut NaN, so the fit returns a NaN model with no inliers.  The port's
    ``robust_fit`` marks non-finite candidates invalid and, on the same
    draws (the static sample, then 15 samples of a moving scene), keeps a
    finite winner with the scene's 40 points as inliers."""
    from ofps_torch.ops import robust as tr
    from ofps_tpu.ops import robust as jr

    ones = np.ones(7, np.float32)
    ref_f, ref_v = map(np.asarray, je.seven_point_fundamental(_STATIC7, _STATIC7, ones))
    got_f, got_v = te.seven_point_fundamental(_t(_STATIC7), _t(_STATIC7), _t(ones))
    assert np.isnan(ref_f[0]).all() and ref_v[0]
    assert bool(torch.isnan(got_f[0]).all()) and bool(got_v[0])

    x1s, x2s, _, _ = _scenes(2, max_deg=5.0)
    x1 = np.concatenate([_STATIC7, x1s[0]])
    x2 = np.concatenate([_STATIC7, x2s[0]])
    w = np.ones(len(x1), np.float32)
    rng = np.random.default_rng(0)
    idx = np.concatenate([np.arange(7)[None], 7 + rng.integers(0, 40, (15, 7))]).astype(np.int32)
    kw = dict(sample_size=7, num_hypotheses=16, threshold=1e-4, adaptive_threshold=True)
    monkeypatch.setattr(jr, "sample_indices", lambda *a, **k: jnp.asarray(idx))
    ref = jr.robust_fit(jax.random.PRNGKey(0), *map(jnp.asarray, (x1, x2, w)),
                        minimal_fit=je.seven_point_fundamental,
                        error_fn=je.sampson_error, refit_fn=je.eight_point_fundamental, **kw)
    assert np.isnan(np.asarray(ref.model)).all() and float(np.asarray(ref.inliers).sum()) == 0
    got = tr.robust_fit(_t(x1), _t(x2), _t(w), minimal_fit=te.seven_point_fundamental,
                        error_fn=te.sampson_error, refit_fn=te.eight_point_fundamental,
                        idx=torch.from_numpy(idx).long(), **kw)
    assert bool(torch.isfinite(got.model).all()) and int(got.best) >= 3  # not the static sample's
    assert float(got.inliers[7:].sum()) == 40


def test_cubic_roots_match():
    rng = np.random.default_rng(2)
    c = rng.normal(size=(4, 64)).astype(np.float32)
    ref_r, ref_v = jax.vmap(je._cubic_roots_real)(*c)
    got_r, got_v = te._cubic_roots_real(*map(_t, c))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    assert {True, False} <= set(np.asarray(ref_v)[:, 1].tolist())  # both branches
    v = np.asarray(ref_v)
    np.testing.assert_allclose(got_r.numpy()[v], np.asarray(ref_r)[v], rtol=1e-4, atol=1e-5)


def test_sampson_error_matches_and_broadcasts():
    x1, x2, _, _ = _scenes(3, noise=1e-2)
    f = np.stack([np.asarray(je.eight_point_fundamental(x1[b], x2[b], np.ones(40, np.float32)))
                  for b in range(B)])
    # Every scene's F against every scene's points: (B models, B, 40).
    ref = np.stack([np.asarray(je.sampson_error(f, x1[b], x2[b])) for b in range(B)], axis=1)
    got = te.sampson_error(_t(f)[:, None], _t(x1)[None], _t(x2)[None]).numpy()
    assert got.shape == (B, B, 40)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_essential_projection_and_decomposition_match():
    x1, x2, _, _ = _scenes(4, noise=1e-3)
    f = te.eight_point_fundamental(_t(x1), _t(x2), torch.ones(B, 40)).numpy()
    ref = jax.vmap(je.project_to_essential)(f)
    got = te.project_to_essential(_t(f))
    assert _rel_up_to_sign(got, ref) <= 1e-5
    ref_r, ref_t = jax.vmap(je.decompose_essential)(np.asarray(ref))
    got_r, got_t = te.decompose_essential(_t(ref))
    assert got_r.shape == (B, 4, 3, 3) and got_t.shape == (B, 4, 3)
    assert _rel_up_to_sign(got_r, ref_r) <= 1e-5
    assert _rel_up_to_sign(got_t[..., None], np.asarray(ref_t)[..., None]) <= 1e-5
    k = np.array([[1.2, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1]], np.float32)
    np.testing.assert_allclose(te.essential_from_fundamental(_t(f), _t(k)).numpy(),
                               np.asarray(jax.vmap(je.essential_from_fundamental, (0, None))(f, k)),
                               rtol=1e-5, atol=1e-6)


def _true_essential(r, t):
    tx = np.stack([np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]]) for v in t])
    return (tx @ r).astype(np.float32)


def test_recover_pose_matches_and_finds_truth():
    x1, x2, r_true, t_true = _scenes(5)
    w = np.ones((B, 40), np.float32)
    e = _true_essential(r_true, t_true)
    ref_r, ref_t, ref_s = jax.vmap(je.recover_pose_from_essential)(e, x1, x2, w)
    got_r, got_t, got_s = te.recover_pose_from_essential(_t(e), _t(x1), _t(x2), _t(w))
    assert _deg(got_r, ref_r).max() <= 2e-3
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), atol=1e-5)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    assert _deg(got_r, r_true).max() <= 2e-3  # the cheirality vote picks the truth
    ref_r1, _, _ = jax.vmap(je.motion_from_essential_and_correspondence, (0, None, 0, 0))(
        e, np.eye(3, dtype=np.float32), x1[:, 0], x2[:, 0])
    got_r1, _, _ = te.motion_from_essential_and_correspondence(
        _t(e), torch.eye(3), _t(x1[:, 0]), _t(x2[:, 0]))
    assert _deg(got_r1, ref_r1).max() <= 2e-3


def test_refine_pose_sampson_matches_on_decisive_steps():
    """Noisy correspondences and a start pose 1 degree and 0.1 rad of
    translation direction off: each Gauss-Newton step cuts the SSE by far
    more than float32 rounding, so both packages accept the same steps."""
    x1, x2, r_true, t_true = _scenes(6, n=200, noise=1e-4)
    w = np.ones((B, 200), np.float32)
    rng = np.random.default_rng(7)
    r0 = np.stack([_rotm(rng.normal(size=3), np.deg2rad(1.0)) @ r for r in r_true]).astype(np.float32)
    t0 = (t_true + 0.1 * rng.normal(size=t_true.shape)).astype(np.float32)
    ref_r, ref_t = jax.jit(jax.vmap(je.refine_pose_sampson))(r0, t0, x1, x2, w)
    got_r, got_t = te.refine_pose_sampson(_t(r0), _t(t0), _t(x1), _t(x2), _t(w))
    assert _deg(got_r, ref_r).max() <= 2e-3
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), atol=1e-4)
    assert _deg(got_r, r_true).max() < 0.1 < _deg(r0, r_true).min()  # it moved


def test_rodrigues_jacobian_at_zero_is_nonzero():
    """The Taylor-guarded exp map has the generators [e_k]x as its tangent
    at 0 (a where(th > eps, R, I) form would give zero there)."""
    jac = torch.func.jacfwd(te._rodrigues)(torch.zeros(3))  # (3, 3, 3)
    want = torch.stack([te._cross_mat(e) for e in torch.eye(3)], dim=-1)
    torch.testing.assert_close(jac, want, rtol=0, atol=0)
    w = np.array([[0.0, 0.0, 0.0], [1e-7, 0.0, 0.0], [0.3, -0.2, 0.1]], np.float32)
    np.testing.assert_allclose(te._rodrigues(_t(w)).numpy(), np.asarray(jax.vmap(je._rodrigues)(w)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("translation", [0.0, 0.3])
def test_rotation_only_fallback_matches(translation):
    """The same decision and rotation as JAX's, on pure rotation against an
    epipolar rotation 0.5 degree off and with a forward translation against
    the true rotation.  On pure rotation with weights summing to 10 the
    Kabsch model wins and recovers the rotation; with unit weights over
    the points it is not taken, in either package: the 6 Newton polar steps
    start from the weighted sum of d2 d1ᵀ (singular values ~95, 3, 2 here)
    and halve a scale per step while far from 1, so they end far from a
    rotation.  The estimators call it with unit inlier weights over
    thousands of points."""
    x1, _, r_true, _ = _scenes(8, n=100)
    rng = np.random.default_rng(9)
    x = np.concatenate([x1, np.ones_like(x1[..., :1])], -1) * rng.uniform(2, 6, (B, 100, 1))
    x2c = np.einsum("bij,bnj->bni", r_true, x) + translation * np.array([0.1, 0.2, 1.0])
    x2 = (x2c[..., :2] / x2c[..., 2:3] + rng.normal(0, 1e-4, (B, 100, 2))).astype(np.float32)
    off = 0.5 if translation == 0.0 else 0.0
    r_epi = np.stack([_rotm(rng.normal(size=3), np.deg2rad(off)) @ r for r in r_true]).astype(np.float32)
    for w in (np.full((B, 100), 0.1, np.float32), np.ones((B, 100), np.float32)):
        ref_r, ref_used = jax.vmap(je.rotation_only_fallback)(r_epi, x1, x2, w)
        got_r, got_used = te.rotation_only_fallback(_t(r_epi), _t(x1), _t(x2), _t(w))
        np.testing.assert_array_equal(got_used.numpy(), np.asarray(ref_used))
        assert _deg(got_r, ref_r).max() <= 2e-3
        if translation == 0.0:
            assert bool(got_used.all()) == (w[0, 0] < 1.0)
            if w[0, 0] < 1.0:
                assert _deg(got_r, r_true).max() < 0.01
            else:
                np.testing.assert_array_equal(got_r.numpy(), r_epi)


def test_quat_axis_angle_round_trip_matches():
    rng = np.random.default_rng(10)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0] = [1.0, 0.0, 0.0, 0.0]  # identity: the +x default axis
    q[1] = -q[1]
    ref_axis, ref_ang = jq.axis_angle(jnp.asarray(q))
    got_axis, got_ang = tq.axis_angle(_t(q))
    np.testing.assert_allclose(got_axis.numpy(), np.asarray(ref_axis), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_ang.numpy(), np.asarray(ref_ang), rtol=0, atol=1e-6)
    ang = np.linspace(0.0, 6.0, 16).astype(np.float32)
    np.testing.assert_allclose(tq.from_axis_angle(got_axis, _t(ang)).numpy(),
                               np.asarray(jq.from_axis_angle(ref_axis, ang)), rtol=0, atol=1e-6)
