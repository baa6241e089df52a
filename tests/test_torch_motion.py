"""Parity of the port's motion-field layer, quaternions, camera and plane
geometry (ofps_torch.core, ofps_torch.ops.geometry_uv) with ofps_tpu.

The numpy plan helpers are copies and must agree exactly; float32 tensor
math agrees to rounding (1e-6 for unit-scale values: a few ulps of
transcendental and reassociation differences between XLA and torch).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofps_torch.core import camera as tcam
from ofps_torch.core import motion as tmo
from ofps_torch.core import quat as tq
from ofps_torch.ops import geometry_uv as tgeo
from ofps_tpu.core import camera as jcam
from ofps_tpu.core import motion as jmo
from ofps_tpu.core import quat as jq
from ofps_tpu.ops import geometry_uv as jgeo
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.mark.parametrize(
    "h,w,gh,gw,border", [(1080, 1920, 84, 150, 48), (96, 160, 90, 150, 6), (97, 161, 13, 21, 0)]
)
def test_grid_scatter_plan_np_exact(h, w, gh, gw, border):
    ref = jmo.grid_scatter_plan_np(h, w, gh, gw, border)
    got = tmo.grid_scatter_plan_np(h, w, gh, gw, border)
    for a, b in zip(got, ref):
        if a is None or b is None:
            assert a is None and b is None
        else:
            np.testing.assert_array_equal(a, b)


def test_grid_size_for_matches():
    for w, h in ((1920, 1080), (160, 96), (90, 300), (64, 48)):
        assert tmo.grid_size_for(w, h) == jmo.grid_size_for(w, h)


def test_grid_downsample_uv_matches():
    rng = np.random.default_rng(0)
    u, v = (rng.standard_normal((2, 96, 160)).astype(np.float32) * 3 for _ in range(2))
    ref = np.asarray(jmo.grid_downsample_uv(jnp.asarray(u), jnp.asarray(v), 150, 90,
                                            norm_wh=(160, 96), border_px=6))
    got = tmo.grid_downsample_uv(_t(u), _t(v), 150, 90, norm_wh=(160, 96), border_px=6)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)


def test_field_to_sparse_matches():
    field = np.random.default_rng(1).standard_normal((2, 9, 15, 2)).astype(np.float32)
    got = tmo.field_to_sparse(_t(field))
    for b in range(2):
        ref = jmo.field_to_sparse(jnp.asarray(field[b]))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(r))


def test_densifier_matches():
    rng = np.random.default_rng(2)
    pos = rng.uniform(-0.1, 1.1, (300, 2)).astype(np.float32)
    mot = rng.standard_normal((300, 2)).astype(np.float32)
    mask = (rng.uniform(size=300) > 0.2).astype(np.float32)
    ref = np.asarray(
        jmo.Densifier.zeros(14, 14)
        .add_flow(jmo.SparseFlow(jnp.asarray(pos), jnp.asarray(mot), jnp.asarray(mask)))
        .finalize()
    )
    got = tmo.Densifier.zeros(14, 14).add_flow(
        tmo.SparseFlow(_t(pos), _t(mot), _t(mask))
    ).finalize()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=TOL)


def test_quat_ops_match():
    rng = np.random.default_rng(3)
    e = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    qj = jq.from_euler(e[:, 0], e[:, 1], e[:, 2])
    qt = tq.from_euler(_t(e[:, 0]), _t(e[:, 1]), _t(e[:, 2]))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=TOL)
    q2 = np.roll(np.asarray(qj), 1, axis=0)
    v = rng.standard_normal((5, 3)).astype(np.float32)
    pairs = (
        (tq.mul(qt, _t(q2)), jq.mul(qj, jnp.asarray(q2))),
        (tq.rotate_vec(qt, _t(v)), jq.rotate_vec(qj, jnp.asarray(v))),
        (tq.to_matrix4(qt), jq.to_matrix4(qj)),
        (tq.angle_to(qt, _t(q2)), jq.angle_to(qj, jnp.asarray(q2))),
        (torch.stack(tq.to_euler(qt), -1), jnp.stack(jq.to_euler(qj), -1)),
    )
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2 * TOL)


def test_camera_rotate_matches():
    rng = np.random.default_rng(4)
    pts = rng.uniform(0.05, 0.95, (64, 2)).astype(np.float32)
    jc, tc = jcam.StandardCamera.create(16 / 9, 60.0), tcam.StandardCamera.create(16 / 9, 60.0)
    q = jq.from_euler(0.01, -0.02, 0.015)
    ref = np.asarray(jc.delta(jnp.asarray(pts), jq.to_matrix4(q)))
    got = tc.delta(_t(pts), tq.to_matrix4(_t(np.asarray(q))))
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL)
    np.testing.assert_allclose(tc.proj().numpy(), np.asarray(jc.proj()), atol=TOL)
    np.testing.assert_allclose(tc.inv_proj().numpy(), np.asarray(jc.inv_proj()), rtol=1e-6)


def test_geometry_planes_match():
    rng = np.random.default_rng(5)
    px, py = (rng.uniform(0, 1, (3, 40)).astype(np.float32) for _ in range(2))
    jc, tc = jcam.StandardCamera.create(1.5, 75.0), tcam.StandardCamera.create(1.5, 75.0)
    q = np.asarray(jq.from_euler(0.02, 0.01, -0.03))
    rj = jgeo.qmat(tuple(jnp.asarray(c) for c in q))
    rt = tgeo.qmat(tuple(_t(c) for c in q))
    dj = jgeo.delta_planes(jc, jnp.asarray(px), jnp.asarray(py), rj)
    dt = tgeo.delta_planes(tc, _t(px), _t(py), rt)
    aj = jgeo.point_angle_planes(jc, jnp.asarray(px), jnp.asarray(py))
    at = tgeo.point_angle_planes(tc, _t(px), _t(py))
    for g, r in zip(dt + at, dj + aj):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL)
    a = tuple(rng.standard_normal(7).astype(np.float32) for _ in range(6))
    b = tuple(rng.standard_normal(7).astype(np.float32) for _ in range(3))
    sj = jgeo.solve3_planes(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)))
    st = tgeo.solve3_planes(tuple(map(_t, a)), tuple(map(_t, b)))
    for g, r in zip(st, sj):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)


# -- the codec-MV path's motion layer ----------------------------------------
#
# Three fills of a grid: a tenth of the cells hold vectors, none do, every
# cell does.  On a 24x18 grid (432 cells: the one-hot accumulation) and a
# 40x30 grid (1,200 cells: scatter_add).  Tolerance TOL (1e-6), and equal
# where the result is exact (from_arrays, the filled-cell pattern).

FILLS = {"tenth": 0.1, "empty": 0.0, "full": 1.0}


def _fill_flow(fill, w, h, seed=7):
    """Flow entries on ``fill`` of the (w, h) cells (1-3 each, jittered
    within the cell), plus masked entries anywhere."""
    rng = np.random.default_rng(seed)
    cells = np.flatnonzero(rng.uniform(size=w * h) < fill) if fill < 1 else np.arange(w * h)
    reps = rng.integers(1, 4, len(cells))
    c = np.repeat(cells, reps)
    cell_xy = np.stack([c % w / (w - 1), c // w / (h - 1)], -1)
    pos = cell_xy + rng.uniform(-0.4, 0.4, (len(c), 2)) / (np.array([w, h]) - 1)
    junk = rng.uniform(0, 1, (50, 2))
    pos = np.concatenate([pos, junk]).astype(np.float32)
    mot = rng.normal(0, 0.02, pos.shape).astype(np.float32)
    mask = np.concatenate([np.ones(len(c)), np.zeros(len(junk))]).astype(np.float32)
    return pos, mot, mask


def test_from_arrays_pads_and_truncates():
    rng = np.random.default_rng(8)
    pos, mot = rng.uniform(size=(2, 50, 2)).astype(np.float32)
    for n, cap in ((50, 64), (50, 20), (0, None), (50, None)):
        got = tmo.SparseFlow.from_arrays(pos[:n], mot[:n], cap, device="cpu")
        ref = jmo.SparseFlow.from_arrays(pos[:n], mot[:n], cap)
        assert got.capacity == ref.capacity
        assert float(got.count()) == float(ref.count())
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("fill", list(FILLS))
@pytest.mark.parametrize("w,h", [(24, 18), (40, 30)])
def test_densify_fill_blur_match(fill, w, h):
    pos, mot, mask = _fill_flow(FILLS[fill], w, h)
    jflow = jmo.SparseFlow(jnp.asarray(pos), jnp.asarray(mot), jnp.asarray(mask))
    tflow = tmo.SparseFlow(_t(pos), _t(mot), _t(mask))
    ref = np.asarray(jmo.densify(jflow, w, h))
    got = tmo.densify(tflow, w, h)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)

    jd = jmo.Densifier.zeros(w, h).add_flow(jflow)
    td = tmo.Densifier.zeros(w, h).add_flow(tflow)
    assert td.shape == jd.shape == (w, h)
    ji, ti = jd.interpolate_empty_cells(), td.interpolate_empty_cells()
    np.testing.assert_array_equal((ti.counts > 0.1).numpy(), np.asarray(ji.counts > 0.1))
    np.testing.assert_allclose(ti.counts.numpy(), np.asarray(ji.counts), rtol=1e-6, atol=TOL)
    filled = ti.finalize()
    np.testing.assert_allclose(filled.numpy(), np.asarray(ji.finalize()), rtol=0, atol=TOL)
    if fill != "empty":
        assert bool((ti.counts > 0.1).all())  # every hole reached

    np.testing.assert_allclose(
        tmo.gaussian_blur(filled, 11).numpy(),
        np.asarray(jmo.gaussian_blur(jnp.asarray(filled.numpy()), 11)), rtol=0, atol=TOL)
    gw, gh = w // 3, h // 4
    np.testing.assert_allclose(
        tmo.grid_downsample_field(filled, gw, gh).numpy(),
        np.asarray(jmo.grid_downsample_field(jnp.asarray(filled.numpy()), gw, gh)),
        rtol=0, atol=TOL)


def test_onehot_accumulation_is_blockwise_and_batched():
    """Across several point blocks, batched streams accumulate as each
    stream alone does (the one-hot sums run per stream, block by block)."""
    rng = np.random.default_rng(9)
    n = 2 * tmo.ONEHOT_BLOCK + 100
    pos = rng.uniform(0, 1, (3, n, 2)).astype(np.float32)
    mot = rng.normal(0, 0.01, (3, n, 2)).astype(np.float32)
    mask = (rng.uniform(size=(3, n)) > 0.3).astype(np.float32)
    flow = tmo.SparseFlow(_t(pos), _t(mot), _t(mask))
    got = tmo.Densifier.zeros(14, 14, (3,)).add_flow(flow)
    for b in range(3):
        one = tmo.Densifier.zeros(14, 14).add_flow(tmo.SparseFlow(flow.pos[b], flow.motion[b],
                                                                  flow.mask[b]))
        assert torch.equal(got.counts[b], one.counts) and torch.equal(got.sums[b], one.sums)
        ref = jmo.Densifier.zeros(14, 14).add_flow(
            jmo.SparseFlow(jnp.asarray(pos[b]), jnp.asarray(mot[b]), jnp.asarray(mask[b])))
        np.testing.assert_allclose(one.finalize().numpy(), np.asarray(ref.finalize()),
                                   rtol=0, atol=TOL)
