"""A band of the port's spatial route runs the unsharded pyramid's
algorithm; JAX's does not where a level's size crosses ``fuse_min_pixels``
(``ofps_torch/parallel/spatial.py``).

JAX's band picks each level's refine from the band's own size: on 64x256
frames over four bands (64 + 2 x 64 halo columns each) with
``fuse_min_pixels`` 14,000, the frame's finest level (16,384 px) takes the
axis-separable refine and the band's (12,288 px) the 2-D sweep, and JAX's
spatial route misses its own gate against its unsharded flow
(``tests/test_spatial_shard.py``: mean EPE < 0.05 px, 99th percentile <
0.75 px), even 16 rows and the coarsest level's reach, 20 columns, off the
edges.  The port's bands choose by the frame's sizes and meet it over the
whole frame (its outer bands take no edge-replicated columns).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from scipy.ndimage import gaussian_filter

from ofps_torch import interop
from ofps_torch.ops import flow_pyramid as tfp
from ofps_torch.parallel import make_stream_mesh as t_mesh
from ofps_torch.parallel.spatial import dense_flow_warm_spatial as t_spatial
from ofps_tpu.ops.flow_pyramid import FlowParams as JFlowParams
from ofps_tpu.ops.flow_pyramid import dense_flow_warm as j_dense_flow_warm
from ofps_tpu.parallel import make_stream_mesh as j_mesh
from ofps_tpu.parallel.spatial import dense_flow_warm_spatial as j_spatial
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PARAMS = JFlowParams(levels=3, coarse_search=3, fuse_min_pixels=14_000)
ROWS, COLS = 16, (3 + 5 // 2) * 2 ** 2  # off the edges: 16 rows, the reach in columns


def _moving_scene(b, h, w, shift=2, seed=3):
    """``tests/test_spatial_shard.py``'s scene."""
    rng = np.random.default_rng(seed)
    big = gaussian_filter(rng.standard_normal((b, h, w + 16)).astype(np.float32), (0, 1.5, 1.5)) * 120
    return big[:, :, 8 : 8 + w], big[:, :, 8 - shift : 8 - shift + w]


def _epe(u, v, ru, rv, rows=ROWS, cols=COLS):
    e = np.hypot(np.asarray(u) - np.asarray(ru), np.asarray(v) - np.asarray(rv))
    e = e[:, rows : e.shape[1] - rows, cols : e.shape[2] - cols]
    return float(e.mean()), float(np.percentile(e, 99))


@pytest.fixture(scope="module")
def scene():
    return _moving_scene(2, 64, 256)


def test_jax_bands_switch_refine_and_miss_the_gate(scene):
    i1, i2 = scene
    (u0, v0), _ = jax.jit(lambda a, b: j_dense_flow_warm(a, b, PARAMS))(i1, i2)
    jm = j_mesh(8, space=4)
    spec = NamedSharding(jm, P("stream", None, "space"))
    with jm:
        (u1, v1), _ = jax.jit(lambda a, b: j_spatial(a, b, PARAMS, None, jm))(
            jax.device_put(jnp.asarray(i1), spec), jax.device_put(jnp.asarray(i2), spec))
    mean, p99 = _epe(u1, v1, u0, v0)
    assert p99 >= 0.75, (mean, p99)  # the reference's route misses its gate


def test_port_bands_follow_the_frame_and_meet_the_gate(scene, monkeypatch):
    i1, i2 = (torch.from_numpy(np.ascontiguousarray(x)) for x in scene)
    params = interop.flow_params_from_jax(PARAMS)
    (u0, v0), _, _ = tfp.dense_flow_warm(i1, i2, params)
    calls = {"sep": 0, "2d": 0}

    def counted(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    ops = tfp._PLAIN_OPS
    monkeypatch.setattr(tfp, "_KERNEL_OPS", ops._replace(
        refine_sep=counted("sep", ops.refine_sep), refine_2d=counted("2d", ops.refine_2d)))
    (u1, v1), _ = t_spatial(i1, i2, params, None, t_mesh(8, space=4, devices=["cpu"] * 8))
    # Per band: the finest level axis-separable as in the frame; level 1
    # and the guarded coarsest level (two sweeps) on the 2-D sweep.
    assert calls == {"sep": 8, "2d": 8 * 3}, calls
    mean, p99 = _epe(u1, v1, u0, v0, 0, 0)
    assert mean < 0.05 and p99 < 0.75, (mean, p99)
