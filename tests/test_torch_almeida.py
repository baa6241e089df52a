"""Parity of the port's almeida estimator and RANSAC helpers with ofps_tpu.

Fields are synthetic camera rotations on the serving grid's lattice
(150 x 90 points, all valid, or a third invalid for the masked path),
computed with the JAX camera, plus noise and
outliers.  Quaternions must agree within 1e-5: the same float32 solve
repeated 30 times, differing only in transcendental ulps and reduction
order.  torch cannot reproduce jax.random, so the RANSAC parity injects
the hypothesis draws JAX made; the torch sampler gets a statistical check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofps_torch.core.camera import StandardCamera as TCam
from ofps_torch.core.motion import SparseFlow as TSparse
from ofps_torch.core.quat import angle_to as quat_angle_to
from ofps_torch.estimators import almeida as talm
from ofps_torch.estimators.base import create_estimator
from ofps_torch.ops import robust as trob
from ofps_tpu.core import quat as jq
from ofps_tpu.core.camera import StandardCamera as JCam
from ofps_tpu.core.motion import SparseFlow as JSparse
from ofps_tpu.core.motion import field_to_sparse
from ofps_tpu.estimators import almeida as jalm
from ofps_tpu.ops import robust as jrob

QUAT_TOL = 1e-5
JCAM = JCam.create(150 / 90, 60.0)


@jax.jit
def _j_ransac(key, pos, mot, mask):
    return jalm.solve_ypr_ransac(key, JCAM, JSparse(pos, mot, mask), 200, 0.05, 1000, dense=True)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _rotation_field(seed, gw=150, gh=90, outliers=0.2):
    """(pos, motion, mask) of a rotation seen on the gh x gw lattice."""
    rng = np.random.default_rng(seed)
    cam = JCam.create(gw / gh, 60.0)
    lattice = field_to_sparse(jnp.zeros((gh, gw, 2), jnp.float32))
    q = jq.from_euler(*(rng.uniform(-0.01, 0.01, 3).astype(np.float32)))
    mot = np.array(cam.delta(lattice.pos, jq.to_matrix4(q)))
    mot += rng.normal(0, 2e-5, mot.shape).astype(np.float32)
    bad = rng.uniform(size=len(mot)) < outliers
    mot[bad] = rng.normal(0, 0.01, (bad.sum(), 2)).astype(np.float32)
    return np.asarray(lattice.pos), mot.astype(np.float32), np.ones(len(mot), np.float32)


def test_solve_ypr_weighted_matches():
    pos, mot, _ = _rotation_field(0, outliers=0.0)
    w = (np.random.default_rng(1).uniform(size=len(pos)) > 0.3).astype(np.float32)
    ref = jalm.solve_ypr_weighted(JCam.create(150 / 90, 60.0), jnp.asarray(pos),
                                  jnp.asarray(mot), jnp.asarray(w))
    got = talm.solve_ypr_weighted(TCam.create(150 / 90, 60.0), _t(pos), _t(mot), _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=QUAT_TOL)


@pytest.mark.parametrize("seed", [2, 3])
def test_solve_ypr_ransac_dense_matches_with_injected_draws(seed):
    pos, mot, mask = _rotation_field(seed)
    key = jax.random.PRNGKey(seed)
    ref = _j_ransac(key, jnp.asarray(pos), jnp.asarray(mot), jnp.asarray(mask))
    # The draws solve_ypr_ransac made: its first key split, dense sampler.
    fit_idx = np.array(
        jrob.sample_indices(jax.random.split(key)[0], jnp.asarray(mask), 200, 3, dense=True)
    )
    got = talm.solve_ypr_ransac(
        None, TCam.create(150 / 90, 60.0), TSparse(_t(pos), _t(mot), _t(mask)),
        200, 0.05, 1000, dense=True, fit_idx=torch.from_numpy(fit_idx),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=QUAT_TOL)
    # Batched: two streams in one call give each stream's own answer.
    batched = talm.solve_ypr_ransac(
        None, TCam.create(150 / 90, 60.0),
        TSparse(*(torch.stack([_t(x)] * 2) for x in (pos, mot, mask))),
        200, 0.05, 1000, dense=True, fit_idx=torch.from_numpy(fit_idx),
    )
    np.testing.assert_allclose(batched.numpy(), np.stack([got.numpy()] * 2), rtol=0, atol=1e-7)


@jax.jit
def _j_ransac_masked(key, pos, mot, mask):
    return jalm.solve_ypr_ransac(key, JCAM, JSparse(pos, mot, mask), 200, 0.05, 1000)


@pytest.mark.parametrize("seed", [6, 7])
def test_solve_ypr_ransac_masked_matches_with_injected_draws(seed):
    """dense=False: a third of the points invalid; the masked sampler's
    draws (JAX's, injected) and the eval subset compacted from the mask."""
    pos, mot, _ = _rotation_field(seed)
    mask = (np.random.default_rng(seed + 10).uniform(size=len(pos)) >= 1 / 3).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ref = _j_ransac_masked(key, jnp.asarray(pos), jnp.asarray(mot), jnp.asarray(mask))
    fit_idx = np.array(jrob.sample_indices(jax.random.split(key)[0], jnp.asarray(mask), 200, 3))
    assert (mask[fit_idx] == 1.0).all()
    flow = TSparse(_t(pos), _t(mot), _t(mask))
    got = talm.solve_ypr_ransac(None, TCam.create(150 / 90, 60.0), flow, 200, 0.05, 1000,
                                dense=False, fit_idx=torch.from_numpy(fit_idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=QUAT_TOL)
    # Through the registered estimator, drawing from a generator: only
    # valid points are drawn, and the answer is a rotation near JAX's.
    r, _, _ = create_estimator("almeida").estimate(
        (), flow, TCam.create(150 / 90, 60.0), torch.Generator().manual_seed(seed))
    assert float(quat_angle_to(r, _t(ref))) < np.deg2rad(0.01)


def test_estimator_instance_matches_lsq():
    """The registered estimator without RANSAC is the weighted LSQ."""
    from ofps_torch.estimators.base import create_estimator

    pos, mot, mask = _rotation_field(4, outliers=0.0)
    est = create_estimator("almeida", use_ransac=False)
    r, t, st = est.estimate((), TSparse(_t(pos), _t(mot), _t(mask)), TCam.create(150 / 90, 60.0))
    ref = jalm.solve_ypr_weighted(JCam.create(150 / 90, 60.0), jnp.asarray(pos),
                                  jnp.asarray(mot), jnp.asarray(mask))
    np.testing.assert_allclose(r.numpy(), np.asarray(ref), rtol=0, atol=QUAT_TOL)
    assert st == () and torch.equal(t, torch.zeros(3))


@pytest.mark.parametrize("n,cap", [(12600, 1000), (13500, 2048), (700, 1000)])
def test_dense_eval_indices_exact(n, cap):
    ref = jrob.dense_eval_indices(n, min(cap, n))
    got = trob.dense_eval_indices(n, min(cap, n))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))


def test_uniform_cap_weights_matches():
    mask = (np.random.default_rng(5).uniform(size=(2, 3000)) > 0.4).astype(np.float32)
    ref = np.stack([np.asarray(jrob.uniform_cap_weights(jnp.asarray(m), 700)) for m in mask])
    np.testing.assert_array_equal(trob.uniform_cap_weights(_t(mask), 700).numpy(), ref)


def test_sample_indices_uniform_in_range():
    """Statistical check of the torch sampler: every draw in [0, n), and
    the counts over 20 equal bins pass a chi-square test (df 19, the
    99.9% quantile is 43.8)."""
    n, rows = 12600, 20000
    g = torch.Generator().manual_seed(0)
    idx = trob.sample_indices(g, n, rows, 3)
    assert idx.shape == (rows, 3) and idx.dtype == torch.int64
    assert int(idx.min()) >= 0 and int(idx.max()) <= n - 1
    counts = np.bincount((idx.numpy().ravel() * 20) // n, minlength=20)
    expected = idx.numel() / 20
    assert ((counts - expected) ** 2 / expected).sum() < 43.8
    again = trob.sample_indices(torch.Generator().manual_seed(0), n, rows, 3)
    assert torch.equal(idx, again)
