"""Parity of the port's Nistér 5-point solver (``ofps_torch.ops.five_point``)
with ofps_tpu on the CPU.

A minimal 5-point sample has an exact 4-D null space, so the basis that the
inverse iteration returns inside it is set by float32 rounding, in either
package.  The two packages therefore solve the degree-10 resultant in
different charts, and their candidates come out in different slots, some
of them ill-conditioned: on the 32 samples below JAX's own true-solution
candidate lies up to 1.1e-2 (Frobenius) from the true essential matrix.
So the candidates are compared as sets and against the truth:

* JAX's exact-minimal-solution gate (``tests/test_five_point.py``): one
  valid candidate explains 7 held-out correspondences (mean Sampson error
  <= 1e-6) on each of 12 samples;
* on 32 samples, the port's candidate nearest the true E is within
  max(1e-3, JAX's distance) of it, and at least 80% of each package's
  valid candidates have a valid candidate of the other within 1e-3
  (Frobenius, up to sign; 84% and 86% on this fixture);
* the tangent-root seeds keep ``jax.lax.top_k``'s order where the -inf
  scores tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofps_torch.ops import epipolar as te
from ofps_torch.ops import five_point as tf
from ofps_tpu.ops import five_point as jf


def _rotm(ax, ang):
    ax = ax / np.linalg.norm(ax)
    k = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    return np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * k @ k


def _pose_samples(seed, count, n=12):
    """JAX's fixture: (x1, x2) (count, n, 2) and the true E (count, 3, 3)."""
    rng = np.random.default_rng(seed)
    x1s, x2s, es = [], [], []
    for _ in range(count):
        r = _rotm(rng.normal(size=3), 0.05 + 0.3 * rng.random())
        t = rng.normal(size=3)
        t /= np.linalg.norm(t)
        x = rng.uniform(-1, 1, (n, 3))
        x[:, 2] = rng.uniform(2, 6, n)
        x2c = x @ r.T + t
        x1s.append(x[:, :2] / x[:, 2:3])
        x2s.append(x2c[:, :2] / x2c[:, 2:3])
        e = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]) @ r
        es.append(e / np.linalg.norm(e))
    return tuple(np.asarray(a, np.float32) for a in (x1s, x2s, es))


def _solve_both(x1, x2):
    w = np.ones(x1.shape[:-1], np.float32)
    ref_e, ref_v = jax.jit(jax.vmap(jf.five_point_essential))(x1, x2, w)
    got_e, got_v = tf.five_point_essential(*(torch.from_numpy(a) for a in (x1, x2, w)))
    return (np.asarray(ref_e), np.asarray(ref_v)), (got_e.numpy(), got_v.numpy())


def _nearest(m, cands, valid):
    c = cands[valid]
    if not len(c):
        return np.inf
    return float(np.minimum(np.sqrt(((c - m) ** 2).sum((-2, -1))),
                            np.sqrt(((c + m) ** 2).sum((-2, -1)))).min())


def test_five_point_recovers_exact_minimal_solutions():
    x1, x2, _ = _pose_samples(11, 12)
    _, (es, valid) = _solve_both(x1[:, :5], x2[:, :5])
    assert es.shape == (12, 28, 3, 3) and valid.shape == (12, 28)
    errs = te.sampson_error(torch.from_numpy(es), torch.from_numpy(x1[:, None, 5:]),
                            torch.from_numpy(x2[:, None, 5:])).numpy()  # (12, 28, 7)
    best = np.where(valid[..., None], errs, 1e9).mean(-1).min(-1)
    assert (best <= 1e-6).all(), best
    # Valid candidates are essential matrices: unit norm, det ~ 0.
    np.testing.assert_allclose(np.linalg.norm(es[valid], axis=(-2, -1)), 1.0, atol=1e-5)
    assert np.abs(np.linalg.det(es[valid])).max() < 1e-4


def test_five_point_candidate_sets_match_jax():
    x1, x2, e_true = _pose_samples(11, 32)
    (ref_e, ref_v), (got_e, got_v) = _solve_both(x1[:, :5], x2[:, :5])
    for s in range(32):
        d_ref = _nearest(e_true[s], ref_e[s], ref_v[s])
        d_got = _nearest(e_true[s], got_e[s], got_v[s])
        assert d_got <= max(1e-3, d_ref), (s, d_got, d_ref)
    both = [[_nearest(a[s, j], b[s], bv[s]) <= 1e-3 for s in range(32) for j in np.flatnonzero(av[s])]
            for a, av, b, bv in ((ref_e, ref_v, got_e, got_v), (got_e, got_v, ref_e, ref_v))]
    assert min(np.mean(m) for m in both) >= 0.8, [np.mean(m) for m in both]


# A 5-point sample of the phase-7 fixture of chip_smoke.py (normalized
# coordinates of the 84x150 lattice, x1 then x2, float32 bit patterns) on
# which a chart's root lies so near theta = pi/2 that z = tan(theta) puts
# the unprojected candidate's entries near 1e6: the analytic SVD's
# squared terms overflow and project_to_essential returns exactly zero.
_ZERO5 = np.array([
    0x3f673a3e, 0x0, 0x3e0c2350, 0xbdc511a4, 0x3e603880,
    0xbce138c0, 0x3dfc3f90, 0x0, 0x3e5234f8, 0x3e6138bc,
    0x3f69e718, 0x3b329700, 0x3e2003b0, 0xbddbc764, 0x3e664f58,
    0xbccc4b60, 0x3e0406b0, 0x3b285c00, 0x3e5859c8, 0x3e644560,
], np.uint32).view(np.float32).reshape(2, 5, 2)


def test_zero_candidate_is_invalid_in_the_port(monkeypatch):
    """A fault of the reference that the port does not keep: JAX marks the
    zero candidate of ``_ZERO5`` valid, and a zero E has no Sampson error
    anywhere, so with this sample as the only hypothesis JAX's
    ``robust_fit`` returns the zero matrix with every point an inlier.  The
    port's solver gives a zero candidate too and marks it invalid, and its
    ``robust_fit`` returns a unit-norm essential matrix on the same draw."""
    from ofps_torch.ops import robust as tr
    from ofps_tpu.ops import epipolar as je
    from ofps_tpu.ops import robust as jr

    x1, x2 = _ZERO5
    ones = np.ones(5, np.float32)
    ref_e, ref_v = map(np.asarray, jax.jit(jf.five_point_essential)(x1, x2, ones))
    assert ((np.abs(ref_e).sum((-2, -1)) == 0) & ref_v).any()
    got_e, got_v = tf.five_point_essential(*(torch.from_numpy(a) for a in (x1, x2, ones)))
    zero = got_e.abs().sum((-2, -1)) == 0
    assert bool(zero.any()) and not bool((zero & got_v).any())

    # The sample and a moving scene's 40 points; one hypothesis: the sample.
    s1, s2, _ = _pose_samples(5, 1, n=40)
    p1, p2 = np.concatenate([x1, s1[0]]), np.concatenate([x2, s2[0]])
    w = np.ones(len(p1), np.float32)
    idx = np.arange(5, dtype=np.int32)[None]
    kw = dict(sample_size=5, num_hypotheses=1, threshold=1e-3, adaptive_threshold=True)
    monkeypatch.setattr(jr, "sample_indices", lambda *a, **k: jnp.asarray(idx))
    ref = jr.robust_fit(jax.random.PRNGKey(0), *map(jnp.asarray, (p1, p2, w)),
                        minimal_fit=jf.five_point_essential,
                        error_fn=je.sampson_error, **kw)
    assert not np.asarray(ref.model).any() and float(np.asarray(ref.inliers).sum()) == len(p1)
    got = tr.robust_fit(*(torch.from_numpy(a) for a in (p1, p2, w)),
                        minimal_fit=tf.five_point_essential, error_fn=te.sampson_error,
                        idx=torch.from_numpy(idx).long(), **kw)
    assert bool(got_v[int(got.best)]) and abs(float(torch.linalg.norm(got.model)) - 1.0) < 1e-5


def _jax_seeds(pv):
    """The tangent seeds as JAX's ``_solve_chart`` picks them."""
    absp = jnp.abs(pv)
    locmin = (absp[..., 1:-1] <= absp[..., :-2]) & (absp[..., 1:-1] <= absp[..., 2:])
    mscore = jnp.where(locmin, -absp[..., 1:-1], -jnp.inf)
    return jax.lax.top_k(mscore, jf._EXTRA_SEEDS)[1]


@pytest.mark.parametrize("minima", [0, 1, 2, 9])
def test_tangent_seeds_keep_top_k_order_on_ties(minima):
    """P sampled on the grid with ``minima`` interior local minima of |P|:
    with fewer than 4, the remaining seeds are -inf ties, which
    ``jax.lax.top_k`` fills with the lowest indices in order."""
    th = jnp.asarray(jf._GRID_THJ)
    rng = np.random.default_rng(minima)
    if minima == 0:
        pv = np.asarray(2.0 + th)  # |P| increasing: no interior minimum
    else:
        centers = np.sort(rng.uniform(-1.4, 1.4, minima))
        pv = np.min(np.abs(np.asarray(th)[:, None] - centers[None]) + rng.uniform(0.1, 0.5, minima), -1)
    pv = np.stack([pv, -pv]).astype(np.float32)
    ref = np.asarray(_jax_seeds(jnp.asarray(pv)))
    got = tf._tangent_seeds(torch.from_numpy(pv)).numpy()
    np.testing.assert_array_equal(got, ref)
    absp = np.abs(pv[0])
    found = int(((absp[1:-1] <= absp[:-2]) & (absp[1:-1] <= absp[2:])).sum())
    if found < jf._EXTRA_SEEDS:  # the rest are -inf ties, in index order
        tail = ref[0, found:]
        assert (np.diff(tail) > 0).all() and tail[0] <= found
