"""Parity of the port's libmv estimator (``ofps_torch.estimators.libmv``)
with ofps_tpu on the CPU.

* ``rasterize_prev`` bit-exact, batched, with several entries in cell 0
  (invalid ones dumped there and valid ones whose endpoint lands there) and
  in other cells;
* ``find_nearest`` exact, with queries that find nothing;
* the 3-step translation chain of ``tests/test_estimators.py`` (an
  L-shaped camera path over points at varying depth; the flows padded to
  1,600 entries by hand), 7- and 8-point, with JAX's primary draws and
  chained-field uniforms injected (``jax.random.split`` of each step's key,
  as ``estimate_libmv`` splits it): rotations within 2e-3 degrees,
  translation direction within 1e-3, magnitude within 1e-3 relative, the
  carried ``PrevMotion`` equal (valid exactly, positions and motions within
  1e-6, rotation and anchor translation within 1e-4);
* the ``move_magnitude`` hint: the translation rescaled, its direction kept.
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
from ofps_torch.estimators import libmv as tlm
from ofps_torch.estimators.base import create_estimator as t_est
from ofps_tpu.core import quat as jq
from ofps_tpu.core.camera import StandardCamera as JCam
from ofps_tpu.core.motion import SparseFlow as JSparse
from ofps_tpu.estimators import libmv as jlm
from ofps_tpu.ops import robust as jrob
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

G = jlm.GRID


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.asarray(x).dtype))


def _raster_case(seed, b=2, n=600):
    """Entries whose endpoints collide: a quarter land in cell 0 (half of
    them invalid), the rest on 60 cells, some off the grid (clamped)."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(1, 60, (b, n)) * 7
    ep = (np.stack([cells % G, cells // G], -1) + rng.uniform(0.05, 0.95, (b, n, 2))) / G
    ep[:, : n // 4] = rng.uniform(0.0, 0.02, (b, n // 4, 2))  # cell 0
    ep[:, -10:] += 1.5  # clamped to the last row and column
    pos = rng.uniform(0, 1, (b, n, 2))
    w = (rng.uniform(size=(b, n)) > 0.2).astype(np.float32)
    w[:, : n // 8] = 0.0
    w[1, : n // 4] = 0.0  # stream 1: cell 0 has no valid entry
    return pos.astype(np.float32), (ep - pos).astype(np.float32), w


def test_rasterize_prev_bit_exact():
    pos, mot, w = _raster_case(0)
    got = tlm.rasterize_prev(_t(pos), _t(mot), _t(w))
    ref = jax.vmap(jlm.rasterize_prev)(pos, mot, w)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    valid = got[2].numpy()
    assert valid[0, 0, 0] == 1.0 and valid[1, 0, 0] == 0.0
    assert 40 < valid.sum() < 2 * 70


def test_find_nearest_exact():
    pos, mot, w = _raster_case(1)
    grid = tlm.rasterize_prev(_t(pos), _t(mot), _t(w))
    prev = tlm.PrevMotion(*grid, rot=tq.identity().expand(2, 4), tr=torch.zeros(2, 3),
                          has=torch.ones(2))
    rng = np.random.default_rng(2)
    query = rng.uniform(-0.05, 1.05, (2, 900, 2)).astype(np.float32)
    query[:, :300] = (pos + mot)[:, :300] + rng.normal(0, 0.01, (2, 300, 2))  # near entries
    qw = (rng.uniform(size=(2, 900)) > 0.1).astype(np.float32)
    got = tlm.find_nearest(prev, _t(query), _t(qw))
    jprev = jlm.PrevMotion(*(np.asarray(x) for x in prev))
    ref = jax.vmap(jlm.find_nearest)(jprev, query, qw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    found = got[2].numpy()
    assert 0.1 < found.mean() < 0.9
    assert (got[0].numpy()[~found.astype(bool) & (qw > 0.5)] == 0.0).all()


def _chain_flows():
    """The four positions of JAX's chain test as padded (pos, motion, mask)
    flows of 1,600 entries."""
    from synthetic import calc_view, get_grid

    cam = JCam.create(1.0, 90.0)
    rng = np.random.default_rng(0)
    grid = np.asarray(get_grid(40, 40, cam))
    pts = jnp.asarray(grid * rng.uniform(0.3, 1.0, (len(grid), 1)).astype(np.float32))
    positions = [(0, 0, 0), (0.1, 0, 0), (0.1, 0, 0.05), (0.15, 0, 0.05)]
    flows = []
    for p0, p1 in zip(positions, positions[1:]):
        views = [calc_view(jq.identity(), jnp.asarray(p, jnp.float32)) for p in (p0, p1)]
        a, b = (np.asarray(cam.project(pts, v)) for v in views)
        keep = (np.abs(a - 0.5).max(1) < 0.5) & (np.abs(b - 0.5).max(1) < 0.5)
        n = int(keep.sum())
        pos, mot, mask = np.zeros((1600, 2), np.float32), np.zeros((1600, 2), np.float32), np.zeros(1600, np.float32)
        pos[:n], mot[:n], mask[:n] = a[keep], (b - a)[keep], 1.0
        flows.append((pos, mot, mask))
    return cam, flows


def _draws(key, mask, algo_points):
    """JAX's draws inside ``estimate_libmv``: the primary solve's masked
    indices from the key's first split, the chained field's uniforms from
    its second."""
    k1, k2 = jax.random.split(key)
    h = jrob.ransac_budget(0.999, 0.7, algo_points, 512)
    idx = jrob.sample_indices(k1, jnp.asarray(mask), h, algo_points)
    return _t(idx).long(), _t(jax.random.uniform(k2, (h, algo_points)))


def _dir_mag(t):
    m = np.linalg.norm(t)
    return t / m, m


@pytest.mark.parametrize("algo_points", [7, 8])
def test_translation_chain_matches_jax(algo_points):
    cam, flows = _chain_flows()
    tcam = TCam.create(1.0, 90.0)
    est = jlm.make_libmv(algo_points=algo_points)
    fn = jax.jit(est.estimate)
    test = t_est("libmv", algo_points=algo_points)
    state, tstate = est.init(), tlm.PrevMotion.empty()
    key = jax.random.PRNGKey(7)
    expected = [(np.array([1.0, 0, 0]), 1.0), (np.array([0, 0, 1.0]), 0.5), (np.array([1.0, 0, 0]), 0.5)]
    for (pos, mot, mask), (edir, emag) in zip(flows, expected):
        key, sub = jax.random.split(key)
        r, t, state = fn(state, JSparse(*map(jnp.asarray, (pos, mot, mask))), cam, sub)
        tr, tt, tstate = test.estimate(tstate, TSparse(_t(pos), _t(mot), _t(mask)), tcam,
                                       fit_idx=_draws(sub, mask, algo_points))
        assert np.degrees(tq.angle_to(_t(r), tr).item()) <= 2e-3
        (gd, gm), (rd, rm) = _dir_mag(tt.numpy()), _dir_mag(np.asarray(t))
        assert np.abs(gd - rd).max() <= 1e-3 and abs(gm - rm) <= 1e-3 * rm
        assert gd @ edir > 0.95 and abs(gm - emag) < 0.05 * emag + 0.02  # JAX's gate
        np.testing.assert_array_equal(tstate.valid.numpy(), np.asarray(state.valid))
        for f, tol in (("pos", 1e-6), ("motion", 1e-6), ("rot", 1e-4), ("tr", 1e-4), ("has", 0.0)):
            np.testing.assert_allclose(getattr(tstate, f).numpy(), np.asarray(getattr(state, f)),
                                       rtol=0, atol=tol, err_msg=f)


def test_move_magnitude_hint_and_interop():
    cam, flows = _chain_flows()
    tcam = TCam.create(1.0, 90.0)
    pos, mot, mask = flows[0]
    key = jax.random.PRNGKey(11)
    est = t_est("libmv", algo_points=8)
    flow = TSparse(_t(pos), _t(mot), _t(mask))
    draws = _draws(key, mask, 8)
    _, t_hint, st_hint = est.estimate(est.init(), flow, tcam, fit_idx=draws, move_magnitude=2.5)
    _, t_plain, _ = est.estimate(est.init(), flow, tcam, fit_idx=draws)
    _, ref_hint, _ = jax.jit(jlm.make_libmv(algo_points=8).estimate)(
        jlm.PrevMotion.empty(), JSparse(*map(jnp.asarray, (pos, mot, mask))), cam, key,
        move_magnitude=jnp.float32(2.5))
    assert abs(float(torch.linalg.norm(t_hint)) - 2.5) < 0.01
    np.testing.assert_allclose(t_hint.numpy(), np.asarray(ref_hint), rtol=0, atol=2.5e-3)
    cos = float(t_hint @ t_plain / (torch.linalg.norm(t_hint) * torch.linalg.norm(t_plain)))
    assert cos > 0.999
    np.testing.assert_allclose(torch.linalg.norm(st_hint.tr).item(), 2.5, rtol=1e-5)  # the anchor
    # Registry, draws and params.
    lm = t_est("libmv")
    idx, u = lm.draw(torch.Generator().manual_seed(0), (3,), 12600, "cpu")
    assert idx.shape == u.shape == (3, 512, 7) and idx.max() < 12600 and u.max() < 1.0
    jp = jlm.LibmvParams(algo_points=8, refit_weight="cauchy", max_error=0.003)
    assert interop.libmv_params_from_jax(jp)._asdict() == jp._asdict()
    assert interop.libmv_params_from_jax(jlm.LibmvParams()) == tlm.LibmvParams()
