"""Parity of the port's block-motion detector and connected components
with ofps_tpu.  Detection is a threshold and a graph walk, so ``detected``,
``area`` and ``mask`` must be exactly equal; the island field agrees to
float32 rounding (1e-6 of the normalized motion).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofps_torch.core.motion import field_to_sparse as t_field_to_sparse
from ofps_torch.detectors import block_motion as tbm
from ofps_torch.detectors.base import create_detector
from ofps_torch.ops.components import label_components as t_label
from ofps_torch.ops.components import largest_component as t_largest
from ofps_tpu.core.motion import field_to_sparse as j_field_to_sparse
from ofps_tpu.detectors import block_motion as jbm
from ofps_tpu.ops.components import label_components as j_label
from ofps_tpu.ops.components import largest_component as j_largest


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _blob_field(seed, gh=84, gw=150):
    """Normalized (gh, gw, 2) field with a few moving blobs."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:gh, 0:gw] / np.array([gh, gw])[:, None, None]
    field = rng.normal(0, 5e-4, (gh, gw, 2)).astype(np.float32)
    for _ in range(3):
        cy, cx, r = rng.uniform(0.1, 0.9), rng.uniform(0.1, 0.9), rng.uniform(0.05, 0.3)
        inside = (ys - cy) ** 2 + (xs - cx) ** 2 < r * r
        field[inside] += rng.uniform(-0.02, 0.02, 2).astype(np.float32)
    return field


@pytest.mark.parametrize("src,dst", [(84, 14), (150, 14), (90, 14), (13, 14)])
def test_axis_cell_matrix_np_exact(src, dst):
    np.testing.assert_array_equal(
        tbm._axis_cell_matrix_np(src, dst), jbm._axis_cell_matrix_np(src, dst)
    )


def _assert_same_detection(got, ref, b=None):
    sel = (lambda x: x[b]) if b is not None else (lambda x: x)
    assert bool(sel(got.detected)) == bool(ref.detected)
    assert int(sel(got.area)) == int(ref.area)
    np.testing.assert_array_equal(sel(got.mask).numpy(), np.asarray(ref.mask))
    np.testing.assert_allclose(sel(got.field).numpy(), np.asarray(ref.field), rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detect_motion_field_and_sparse_match(seed):
    field = _blob_field(seed)
    params = tbm.BlockMotionParams()
    jparams = jbm.BlockMotionParams()
    ref_field = jbm.detect_motion_field(jparams, jnp.asarray(field))
    ref_sparse = jbm.detect_motion(jparams, j_field_to_sparse(jnp.asarray(field)))
    got_field = tbm.detect_motion_field(params, _t(field))
    got_sparse = tbm.detect_motion(params, t_field_to_sparse(_t(field)))
    _assert_same_detection(got_field, ref_field)
    _assert_same_detection(got_sparse, ref_sparse)
    # The port's dense fast path agrees with its own sparse path.
    for a, b in zip(got_field[:3] + (got_field.mask,), got_sparse[:3] + (got_sparse.mask,)):
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
        else:
            assert torch.equal(a, b)


def test_detector_batched_and_registered():
    fields = np.stack([_blob_field(s) for s in (3, 4)])
    det = create_detector("block_motion")
    got = det.detect_field(_t(fields), props={"target_motion": 0.004})
    for b in range(2):
        ref = jbm.detect_motion_field(jbm.BlockMotionParams(), jnp.asarray(fields[b]), 0.004)
        _assert_same_detection(got, ref, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_components_match(seed):
    rng = np.random.default_rng(seed)
    active = rng.uniform(size=(2, 14, 14)) > 0.55
    snake = np.zeros((14, 14), bool)
    snake[::2, :] = True
    snake[1::4, -1] = True
    snake[3::4, 0] = True
    active = np.concatenate([active, snake[None]])
    t_lab = t_label(torch.from_numpy(active))
    t_mask, t_area = t_largest(torch.from_numpy(active))
    for b in range(active.shape[0]):
        np.testing.assert_array_equal(t_lab[b].numpy(), np.asarray(j_label(jnp.asarray(active[b]))))
        j_mask, j_area = j_largest(jnp.asarray(active[b]))
        np.testing.assert_array_equal(t_mask[b].numpy(), np.asarray(j_mask))
        assert int(t_area[b]) == int(j_area)


@pytest.mark.parametrize("density", [0.5, 0.8])
def test_components_match_above_closure_size(density):
    """70x70 grids (4,900 cells, past the closure's 4,096): the
    hook + pointer-jump branch, as ``tests/test_detector.py`` checks JAX's
    (min_size 0.01 at subdivide 7 gives this grid).  Labels, the largest
    component and its area exactly equal, batched over three grids, one
    of them a boustrophedon snake (the longest diameter a grid holds).
    The static 43 rounds do not join the whole 70x70 snake in either
    package (its diameter is ~2,500 cells): the labels still agree."""
    rng = np.random.default_rng(7)
    active = rng.random((2, 70, 70)) < density
    snake = np.zeros((70, 70), bool)
    snake[::2, :] = True
    snake[1::4, -1] = True
    snake[3::4, 0] = True
    active = np.concatenate([active, snake[None]])
    t_lab = t_label(torch.from_numpy(active))
    t_mask, t_area = t_largest(torch.from_numpy(active))
    for b in range(active.shape[0]):
        np.testing.assert_array_equal(t_lab[b].numpy(), np.asarray(j_label(jnp.asarray(active[b]))))
        j_mask, j_area = j_largest(jnp.asarray(active[b]))
        np.testing.assert_array_equal(t_mask[b].numpy(), np.asarray(j_mask))
        assert int(t_area[b]) == int(j_area)
