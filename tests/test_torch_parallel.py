"""The port's multi-device layer (``ofps_torch.parallel.{sharding,spatial}``
and ``StreamPipeline(shardings=...)``, ``run_batch(shardings=...)``) against
ofps_tpu's on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices; the port's
meshes are of CPU devices (``["cpu"] * 8``), the same grid of positions.
The port's frame edges take no halo where JAX's take edge-replicated
columns (``ofps_torch/parallel/spatial.py``), so its spatial route is held
against JAX's unsharded pyramid over the whole frame, and against JAX's
spatial route away from the frame's left and right edges (twice the
coarsest level's reach), where both run the same algorithm on the same
columns.  Tolerances: the halo exchange bit-exact; flow as
``tests/test_torch_flow.py`` holds flow (99.5% of pixels within 1e-4 px,
none off by more than one candidate step); rotations within 1e-4; a
stream-only mesh within 1e-6 of the unsharded port step (the same
operations on fewer streams).
"""

import importlib.util
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from scipy import signal
from scipy.ndimage import gaussian_filter

from ofps_torch import interop
from ofps_torch.apps import batch as tbatch
from ofps_torch.core.camera import StandardCamera as TCam
from ofps_torch.core.motion import SparseFlow as TSparse
from ofps_torch.detectors.base import create_detector as t_det
from ofps_torch.estimators.base import create_estimator as t_est
from ofps_torch.parallel import StreamPipeline as TPipe
from ofps_torch.parallel import make_stream_mesh as t_mesh
from ofps_torch.parallel import stream_sharding as t_sharding
from ofps_torch.parallel.sharding import RowShards, gather, shard_put
from ofps_torch.parallel.spatial import dense_flow_warm_spatial as t_spatial
from ofps_torch.parallel.spatial import exchange_halo as t_exchange_halo
from ofps_torch.parallel.spatial import split_columns
from ofps_tpu.core.camera import StandardCamera as JCam
from ofps_tpu.detectors.base import create_detector as j_det
from ofps_tpu.estimators.base import create_estimator as j_est
from ofps_tpu.ops.flow_pyramid import FlowParams as JFlowParams
from ofps_tpu.ops.flow_pyramid import dense_flow_warm as j_dense_flow_warm
from ofps_tpu.ops.robust import sample_indices as j_sample_indices
from ofps_tpu.parallel import StreamPipeline as JPipe
from ofps_tpu.parallel import make_stream_mesh as j_mesh
from ofps_tpu.parallel import stream_sharding as j_sharding
from ofps_tpu.parallel.spatial import dense_flow_warm_spatial as j_spatial
from ofps_tpu.parallel.spatial import exchange_halo as j_exchange_halo
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU8 = ["cpu"] * 8
PX_TOL = 1e-4
MIN_SHARE = 0.995
STEP = 1.0 + 1e-3
SAME_TOL = 1e-6


def _assert_flow_close(got_u, got_v, ref_u, ref_v):
    d = np.maximum(np.abs(got_u - ref_u), np.abs(got_v - ref_v))
    assert np.isfinite(d).all()
    assert (d <= PX_TOL).mean() >= MIN_SHARE, (d > PX_TOL).mean()
    assert d.max() <= STEP, d.max()


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


# -- sharding -----------------------------------------------------------------


@pytest.mark.parametrize("n,space", [(1, None), (2, None), (4, None), (8, None),
                                     (2, 2), (4, 1), (4, 4), (8, 2), (8, 4)])
def test_make_stream_mesh_shape_matches_jax(n, space):
    ref = j_mesh(n, space=space)
    got = t_mesh(n, space=space, devices=CPU8)
    assert got.axis_names == ref.axis_names == ("stream", "space")
    assert (got.shape["stream"], got.shape["space"]) == ref.devices.shape
    assert all(d == torch.device("cpu") for row in got.devices for d in row)
    assert repr(got).startswith(f"StreamMesh(stream={ref.devices.shape[0]}, "
                                f"space={ref.devices.shape[1]}")


def test_make_stream_mesh_rejects_a_bad_split():
    with pytest.raises(ValueError):
        t_mesh(6, space=4, devices=CPU8)
    with pytest.raises(ValueError):
        t_mesh(9, devices=CPU8)


def test_shard_put_gather_round_trip():
    mesh = t_mesh(8, devices=CPU8)  # (4, 2)
    rng = np.random.default_rng(0)
    tree = {
        "frames": _t(rng.standard_normal((8, 3, 5))),
        "pair": (_t(rng.standard_normal((8, 2))), None),
        "scale": torch.tensor(2.5),
        "flow": TSparse(_t(rng.standard_normal((8, 6, 2))), _t(rng.standard_normal((8, 6, 2))),
                        torch.ones(8, 6)),
    }
    shards = shard_put(tree, t_sharding(mesh))
    assert isinstance(shards, RowShards) and len(shards) == 4
    for r, s in enumerate(shards):
        assert s["frames"].shape == (2, 3, 5) and s["pair"][1] is None
        assert isinstance(s["flow"], TSparse) and s["flow"].pos.shape == (2, 6, 2)
        np.testing.assert_array_equal(s["frames"].numpy(), tree["frames"][2 * r : 2 * r + 2].numpy())
        assert float(s["scale"]) == 2.5
    back = gather(shards, mesh)
    for a, b in zip(jax.tree_util.tree_leaves(_as_np(back)), jax.tree_util.tree_leaves(_as_np(tree))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        shard_put(torch.zeros(6, 2), mesh)


def _as_np(tree):
    from ofps_torch.parallel.sharding import tree_map

    return tree_map(lambda x: x.numpy(), tree)


# -- spatial ------------------------------------------------------------------


def test_exchange_halo_bit_exact_against_jax():
    """``tests/test_spatial_shard.py``'s input on ``make_stream_mesh(8,
    space=4)``: every band of every row, halo included, equals JAX's, but
    for the edge-replicated columns JAX adds at the frame's outer edges."""
    jm = j_mesh(8, space=4)
    w_local, halo = 8, 4
    x = np.arange(2 * 3 * (w_local * 4), dtype=np.float32).reshape(2, 3, w_local * 4)

    @partial(jax.shard_map, mesh=jm, in_specs=P("stream", None, "space"),
             out_specs=P("stream", None, "space"))
    def f(xb):
        return j_exchange_halo(xb, halo, "space")

    with jm:
        ref = np.asarray(f(jnp.asarray(x)))  # (2, 3, 4 * (w_local + 2 halo))
    mesh = t_mesh(8, space=4, devices=CPU8)
    ext = w_local + 2 * halo
    for r, rows in enumerate(shard_put(torch.from_numpy(x), mesh)):
        bands = t_exchange_halo(split_columns(rows, mesh.devices[r]), halo)
        for c, band in enumerate(bands):
            lo = c * ext + (halo if c == 0 else 0)
            hi = (c + 1) * ext - (halo if c == 3 else 0)
            np.testing.assert_array_equal(band.numpy(), ref[r : r + 1, :, lo:hi])


def _moving_scene(b, h, w, shift=2, seed=3):
    """``tests/test_spatial_shard.py``'s scene."""
    rng = np.random.default_rng(seed)
    big = gaussian_filter(rng.standard_normal((b, h, w + 16)).astype(np.float32), (0, 1.5, 1.5)) * 120
    return big[:, :, 8 : 8 + w], big[:, :, 8 - shift : 8 - shift + w]


SPATIAL_PARAMS = JFlowParams(levels=3, coarse_search=3)


def _edge_margin(params) -> int:
    """Columns off the frame's left and right edges where JAX's spatial
    route sees its edge-replicated columns: twice the coarsest level's
    reach."""
    return 2 * (params.coarse_search + params.win // 2) * 2 ** (params.levels - 1)


def _assert_spatial_gate(u, v, ru, rv):
    """``tests/test_spatial_shard.py``'s gate for the spatial route against
    the unsharded flow (mean EPE < 0.05 px, 99th percentile < 0.75 px),
    here over the whole frame."""
    epe = np.hypot(u - ru, v - rv)
    assert np.mean(epe) < 0.05, np.mean(epe)
    assert np.percentile(epe, 99) < 0.75, np.percentile(epe, 99)


@pytest.fixture(scope="module")
def jax_spatial():
    """JAX's unsharded pyramid and its spatial route on
    make_stream_mesh(8, space=4), B=2, 64x128: a cold call, then a call
    warm-started from the cold call's carry."""
    jm = j_mesh(8, space=4)
    i1, i2 = _moving_scene(2, 64, 128)
    spec = NamedSharding(jm, P("stream", None, "space"))
    fn = jax.jit(lambda a, b, w: j_spatial(a, b, SPATIAL_PARAMS, w, jm))
    cold_fn = jax.jit(lambda a, b: j_spatial(a, b, SPATIAL_PARAMS, None, jm))
    with jm:
        a, b = jax.device_put(i1, spec), jax.device_put(i2, spec)
        cold = jax.device_get(cold_fn(a, b))
        warm = jax.device_get(fn(a, b, tuple(jax.device_put(x, spec) for x in cold[1])))
    flat = jax.jit(lambda a, b, w: j_dense_flow_warm(a, b, SPATIAL_PARAMS, warm=w))
    flat_cold = jax.device_get(flat(i1, i2, None))
    flat_warm = jax.device_get(flat(i1, i2, flat_cold[1]))
    return i1, i2, {"cold": (cold, flat_cold), "warm": (warm, flat_warm)}, (cold[1], flat_cold[1])


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_dense_flow_warm_spatial_matches_jax(jax_spatial, start):
    """The inner bands (band + halo the same columns in both packages)
    against JAX's spatial route; the whole frame, edges included, within
    JAX's spatial gate of JAX's unsharded pyramid."""
    i1, i2, runs, carries = jax_spatial
    (ref_sp, ref_flat) = runs[start]
    mesh = t_mesh(8, space=4, devices=CPU8)
    params = interop.flow_params_from_jax(SPATIAL_PARAMS)
    for ref, carry in ((ref_sp, carries[0]), (ref_flat, carries[1])):
        init = None if start == "cold" else tuple(_t(x) for x in carry)
        (u, v), (wu, wv) = t_spatial(_t(i1), _t(i2), params, init, mesh)
        (ru, rv), (rwu, rwv) = ref[0], ref[1]
        assert u.shape == ru.shape == (2, 64, 128) and wu.shape == rwu.shape == (2, 32, 64)
        if ref is ref_sp:
            _assert_flow_close(u[..., 32:96].numpy(), v[..., 32:96].numpy(),
                               _np(ru)[..., 32:96], _np(rv)[..., 32:96])
            _assert_flow_close(wu[..., 16:48].numpy(), wv[..., 16:48].numpy(),
                               _np(rwu)[..., 16:48], _np(rwv)[..., 16:48])
        else:
            _assert_spatial_gate(u.numpy(), v.numpy(), _np(ru), _np(rv))
            _assert_spatial_gate(wu.numpy(), wv.numpy(), _np(rwu), _np(rwv))


# -- the sharded serving step -------------------------------------------------


def _translate_frames(b, h, w, shift):
    """``tests/test_parallel.py``'s scene."""
    base = np.random.RandomState(1).rand(1, h + 8, w + 8).astype(np.float32) * 255
    base = np.repeat(base, b, axis=0)
    k = np.ones((5, 5)) / 25.0
    base = np.stack([signal.convolve2d(f, k, mode="same") for f in base], axis=0)
    return (base[:, 4 : 4 + h, 4 : 4 + w].astype(np.float32),
            base[:, 4 : 4 + h, 4 - shift : 4 - shift + w].astype(np.float32))


STEP_PARAMS = JFlowParams(levels=2, coarse_search=3)
ALMEIDA = {"num_iters": 16, "ransac_samples": 128}


def _t_pipeline(shardings=None, **kw):
    return TPipe(TCam.create(4.0 / 3.0, 90.0), [t_est("almeida", **ALMEIDA)],
                 t_det("block_motion"), flow_params=interop.flow_params_from_jax(STEP_PARAMS),
                 device="cpu", shardings=shardings, **kw)


@pytest.fixture(scope="module")
def jax_sharded_step():
    """``tests/test_parallel.py``'s step, unsharded and sharded on its
    (4, 2) mesh (shard_map + halo route), with one key, and the draws its
    key split made: one key per stream, almeida sampling from the key's
    first split."""
    jm = j_mesh(8)
    shard = j_sharding(jm)
    b, h, w = 4, 32, 64
    f0, f1 = _translate_frames(b, h, w, shift=1)
    key = jax.random.PRNGKey(5)
    outs = {}
    for name, sh in (("unsharded", None), ("sharded", shard)):
        pipe = JPipe(camera=JCam.create(4.0 / 3.0, 90.0),
                     estimators=[j_est("almeida", **ALMEIDA)], detector=j_det("block_motion"),
                     flow_params=STEP_PARAMS, shardings=sh)
        st = pipe.state_with_frame(pipe.init_state(b, h, w), jnp.asarray(f0))
        frame = jnp.asarray(f1)
        if sh is not None:
            st = st._replace(
                prev_cache=jax.tree_util.tree_map(lambda x: jax.device_put(x, sh.image),
                                                  st.prev_cache),
                warm_uv=tuple(jax.device_put(x, sh.image) for x in st.warm_uv),
            )
            frame = jax.device_put(frame, sh.image)
        with jm:
            _, out = jax.jit(pipe.step_from_frames)(st, frame, key)
            outs[name] = jax.device_get(out)
    n = h * w
    draws = np.stack([np.asarray(j_sample_indices(jax.random.split(k)[0], jnp.ones(n), 16, 3,
                                                  dense=True))
                      for k in jax.random.split(key, b)])
    return f0, f1, outs, torch.from_numpy(draws)


def test_sharded_step_matches_jax(jax_sharded_step):
    """The port's (4, 2) step against JAX's unsharded step (flow, rotation,
    detections), and its flow against JAX's sharded step away from the
    frame's left and right edges."""
    f0, f1, refs, draws = jax_sharded_step
    pipe = _t_pipeline(t_sharding(t_mesh(8, devices=CPU8)))
    st = pipe.state_with_frame(pipe.init_state(4, 32, 64), _t(f0))
    assert isinstance(st, RowShards) and len(st) == 4
    assert st[0].prev_cache.pyr[0].shape == (1, 32, 64) and len(st[0].prev_cache.pyr) == 1
    new_state, out = pipe.step_from_frames(st, _t(f1), draws=(draws,))
    ref = refs["unsharded"]
    assert out.flow.shape == ref.flow.shape == (4, 32, 64, 2)
    for r, m in ((ref, 0), (refs["sharded"], _edge_margin(STEP_PARAMS))):
        cols = slice(m, 64 - m)
        _assert_flow_close(out.flow[:, :, cols, 0].numpy(), out.flow[:, :, cols, 1].numpy(),
                           _np(r.flow[:, :, cols, 0]), _np(r.flow[:, :, cols, 1]))
    np.testing.assert_allclose(out.rot[0].numpy(), _np(ref.rot[0]), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out.detection.detected.numpy(), np.asarray(ref.detection.detected))
    assert pipe.gather_state(new_state).has_prev.tolist() == [1.0] * 4


def _assert_same_outputs(got, ref):
    for a, b in zip(_leaves(got), _leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == torch.bool or not a.is_floating_point():
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=SAME_TOL)


def _leaves(tree):
    out = []
    from ofps_torch.parallel.sharding import tree_map

    tree_map(out.append, tree)
    return out


def test_stream_only_step_from_frames_equals_unsharded():
    """(2, 1): the rows run the unsharded step (grid plan, carried pyramid)
    on half the streams each, with the whole batch's draws split."""
    b, h, w = 4, 96, 160
    rng = np.random.default_rng(0)
    bg = gaussian_filter(rng.standard_normal((b, h + 40, w + 40)), (0, 2, 2)) * 100
    frames = [_t(bg[:, 20 : 20 + h, 20 + 2 * t : 20 + 2 * t + w]) for t in range(3)]
    params = JFlowParams(levels=3, coarse_search=3, fuse_min_pixels=3000)
    outs = []
    for sh in (None, t_sharding(t_mesh(2, space=1, devices=CPU8))):
        pipe = TPipe(TCam.create(w / h, 60.0), [t_est("almeida"), t_est("homography")],
                     t_det("block_motion"), flow_params=interop.flow_params_from_jax(params),
                     emit_dense_flow=False, device="cpu", shardings=sh)
        gen = torch.Generator().manual_seed(3)
        st = pipe.init_state(b, h, w)
        steps = []
        for f in frames:
            st, out = pipe.step_from_frames(st, f, gen)
            steps.append(out)
        outs.append((steps, pipe.gather_state(st), pipe))
    (ref, ref_state, _), (got, got_state, pipe) = outs
    assert pipe.eager_runs == 3 * 2 and pipe._rows[0]._grid_plan(h, w) is not None
    _assert_same_outputs(got, ref)
    _assert_same_outputs(got_state, ref_state)


def test_stream_only_step_from_flow_equals_unsharded():
    """The codec-MV step on a (2, 1) mesh: masked draws for the whole
    batch, split over the rows; one stream all masked."""
    b, n = 4, 512
    rng = np.random.default_rng(1)
    pos = _t(rng.uniform(0.02, 0.98, (b, n, 2)))
    motion = _t(0.004 + rng.normal(0, 0.0005, (b, n, 2)))
    mask = _t(rng.random((b, n)) > 0.3)
    mask[2] = 0.0
    flow = TSparse(pos, motion, mask)
    outs = []
    for sh in (None, t_sharding(t_mesh(2, space=1, devices=CPU8))):
        pipe = TPipe(TCam.create(16 / 9, 90.0), [t_est("almeida"), t_est("homography")],
                     t_det("block_motion"), device="cpu", shardings=sh)
        gen = torch.Generator().manual_seed(4)
        st = pipe.init_state(b, 1, 1)
        steps = []
        for _ in range(2):
            st, out = pipe.step_from_flow(st, flow, gen)
            steps.append(out)
        outs.append((steps, pipe.gather_state(st)))
    _assert_same_outputs(outs[1][0], outs[0][0])
    _assert_same_outputs(outs[1][1], outs[0][1])


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_batch_with_shardings_equals_without(tmp_path):
    """Two ``.mvec`` streams of ``chip_smoke.codec_fixture`` through
    ``run_batch`` on a (2, 1) mesh (one stream per row, each row its own
    upload) and without a mesh: the same poses, detections and vectors."""
    mvecs, gts, counts = _load_chip_smoke().codec_fixture(torch, tmp_path, streams=2, frames=4)
    kw = dict(capacity=8192, seed=2, ground_truths=gts, device="cpu")
    ref = tbatch.run_batch(mvecs, **kw)
    got = tbatch.run_batch(mvecs, shardings=t_sharding(t_mesh(2, space=1, devices=CPU8)), **kw)
    assert got.frames == ref.frames == 4 and got.eager_runs == 2 * 4
    np.testing.assert_array_equal(got.vectors, ref.vectors)
    np.testing.assert_array_equal(got.vectors, counts.T)
    np.testing.assert_array_equal(got.detections, ref.detections)
    for a, b in zip(got.poses_rot + got.poses_pos, ref.poses_rot + ref.poses_pos):
        np.testing.assert_allclose(a, b, rtol=0, atol=SAME_TOL)
    for e in range(len(ref.delta_rot)):
        np.testing.assert_allclose(np.stack(got.delta_rot[e]), np.stack(ref.delta_rot[e]),
                                   rtol=0, atol=SAME_TOL)
    assert got.gt_avg_err.keys() == ref.gt_avg_err.keys()
