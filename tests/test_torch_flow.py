"""Parity of the port's dense flow (ofps_torch.ops.flow_pyramid and the
plain versions of the refine kernels) with ofps_tpu's XLA path.

The JAX package runs on the CPU as its own tests run it: its flow stage
takes the XLA path (exact warp, ``_level_refine``, ``_coarse_guard``),
which is the one algorithm the port implements.  Flow tolerance: at least
99.5% of pixels within 1e-4 px, and no pixel off by more than one integer
candidate step; an argmin flip on a float32 near-tie is the only expected
cause of a larger difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from ofps_torch import interop
from ofps_torch.core.motion import grid_downsample_uv as t_grid_downsample_uv
from ofps_torch.kernels import flow_refine as kfr
from ofps_torch.kernels import flow_refine_small as kfs
from ofps_torch.ops import flow_pyramid as tfp
from ofps_tpu.core.motion import grid_downsample_uv as j_grid_downsample_uv
from ofps_tpu.ops import flow_pyramid as jfp
from ofps_tpu.ops.image import warp_bilinear as j_warp

H, W, B = 96, 160, 2
PX_TOL = 1e-4  # float32 rounding through warp, box sums and parabola
MIN_SHARE = 0.995  # share of pixels that must be within PX_TOL
STEP = 1.0 + 1e-3  # one integer candidate step (plus rounding)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _scene(seed, h=H, w=W, batch=B):
    """i1 = i2 warped by a smooth flow (u ~ +3, v ~ -2 px), textured."""
    rng = np.random.default_rng(seed)
    img = gaussian_filter(
        rng.standard_normal((batch, h + 40, w + 40)).astype(np.float32), (0, 2, 2)
    ) * 100
    u = gaussian_filter(rng.standard_normal((batch, h, w)), (0, 20, 20)) * 30 + 3
    v = gaussian_filter(rng.standard_normal((batch, h, w)), (0, 20, 20)) * 20 - 2
    flow = np.stack([u, v], -1).astype(np.float32)
    i2 = img[:, 20 : 20 + h, 20 : 20 + w].copy()
    i1 = np.asarray(j_warp(jnp.asarray(i2), jnp.asarray(flow)))
    return i1, i2, flow


def _assert_flow_close(got_u, got_v, ref_u, ref_v):
    d = np.maximum(np.abs(got_u - ref_u), np.abs(got_v - ref_v))
    assert np.isfinite(d).all()
    assert (d <= PX_TOL).mean() >= MIN_SHARE, (d > PX_TOL).mean()
    assert d.max() <= STEP, d.max()


@pytest.fixture(scope="module")
def scene():
    return _scene(0)


@pytest.mark.parametrize("search,axis_sep", [(1, False), (1, True), (3, False)])
def test_level_refine_matches(scene, search, axis_sep):
    i1, i2, flow = scene
    rng = np.random.default_rng(1)
    init = flow + rng.normal(0, 0.6, flow.shape).astype(np.float32)
    warped = np.asarray(j_warp(jnp.asarray(i2), jnp.asarray(init)))
    ref = np.asarray(
        jax.jit(
            lambda a, b: jfp._level_refine(a, b, search, 5, jnp.bfloat16, axis_sep=axis_sep)
        )(jnp.asarray(i1), jnp.asarray(warped))
    )
    du, dv = tfp._level_refine(_t(i1), _t(warped), search, 5, torch.bfloat16, axis_sep)
    _assert_flow_close(du.numpy(), dv.numpy(), ref[..., 0], ref[..., 1])


def _tie_scene(h, w, s):
    """Binary blocks (0 or 8: every |diff| and box sum is exact, so equal
    costs tie exactly), a flat left third where only the prior separates
    the candidates, and i1 = i2 moved right by s px: the textured part's
    best candidate lies at the edge of the search, dx = -s."""
    rng = np.random.default_rng(7)
    blocks = rng.integers(0, 2, (1, h // 2 + 2, w // 2 + s + 2)).astype(np.float32) * 8
    i2 = np.repeat(np.repeat(blocks, 2, axis=1), 2, axis=2)[:, :h, s : s + w].copy()
    i1 = np.repeat(np.repeat(blocks, 2, axis=1), 2, axis=2)[:, :h, :w].copy()
    i1[:, :, : w // 3] = 8.0
    i2[:, :, : w // 3] = 8.0
    return i1, i2


@pytest.mark.parametrize(
    "h,w,search,axis_sep,ties",
    [(33, 60, 6, False, False), (67, 120, 6, False, False), (33, 60, 6, False, True),
     (67, 121, 1, True, False), (67, 121, 1, True, True)],
)
def test_level_refine_matches_at_kernel_shapes(h, w, search, axis_sep, ties):
    """The kernels' yardstick where a parallel argmin is most at risk: the
    coarse levels' 169-candidate sweep, a tie-heavy scene (exact ties that
    the prior and the dy-outer order must decide, best candidate at +-s)
    and the axis-separable refine at a size that is no multiple of a tile."""
    if ties:
        i1, warped = _tie_scene(h, w, search)
    else:
        i1, i2, flow = _scene(8, h=h, w=w, batch=2)
        rng = np.random.default_rng(9)
        init = flow + rng.normal(0, 0.6, flow.shape).astype(np.float32)
        warped = np.asarray(j_warp(jnp.asarray(i2), jnp.asarray(init)))
    ref = np.asarray(
        jax.jit(
            lambda a, b: jfp._level_refine(a, b, search, 5, jnp.bfloat16, axis_sep=axis_sep)
        )(jnp.asarray(i1), jnp.asarray(warped))
    )
    du, dv = tfp._level_refine(_t(i1), _t(warped), search, 5, torch.bfloat16, axis_sep)
    if ties:
        # Every integer choice equal; the parabola's rounding may differ.
        np.testing.assert_allclose(du.numpy(), ref[..., 0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(dv.numpy(), ref[..., 1], rtol=0, atol=1e-6)
        if not axis_sep:
            assert (du.numpy() == -search).mean() > 0.3  # the edge of the search wins
    else:
        _assert_flow_close(du.numpy(), dv.numpy(), ref[..., 0], ref[..., 1])


@pytest.mark.parametrize("fuse_min_pixels", [3000, 30000])
def test_dense_flow_warm_matches(scene, fuse_min_pixels):
    """3 levels, warm init + coarse guard.  fuse_min_pixels=3000 sends the
    two finer levels through the axis-separable refine, 30000 through the
    2-D sweep: both kernel routes."""
    i1, i2, _ = scene
    jp = jfp.FlowParams(levels=3, coarse_search=3, fuse_min_pixels=fuse_min_pixels)
    tp = interop.flow_params_from_jax(jp)
    rng = np.random.default_rng(2)
    warm = tuple(
        (gaussian_filter(rng.standard_normal((B, H // 2, W // 2)), (0, 4, 4)) * 8 + off)
        .astype(np.float32)
        for off in (1.5, -1.0)
    )
    (uj, vj), wj = jax.jit(lambda a, b, w0, w1: jfp.dense_flow_warm(a, b, jp, warm=(w0, w1)))(
        jnp.asarray(i1), jnp.asarray(i2), *map(jnp.asarray, warm)
    )
    (ut, vt), wt, cache = tfp.dense_flow_warm(
        _t(i1), _t(i2), tp, warm=tuple(map(_t, warm))
    )
    _assert_flow_close(ut.numpy(), vt.numpy(), np.asarray(uj), np.asarray(vj))
    _assert_flow_close(wt[0].numpy(), wt[1].numpy(), np.asarray(wj[0]), np.asarray(wj[1]))
    assert len(cache.pyr) == 3 and torch.equal(cache.pyr[0], _t(i2))


def test_dense_flow_matches_cold(scene):
    """Packed cold-start flow with the border band replicated."""
    i1, i2, _ = scene
    jp = jfp.FlowParams(levels=3, coarse_search=3, fuse_min_pixels=3000)
    ref = np.asarray(jax.jit(lambda a, b: jfp.dense_flow(a, b, jp))(jnp.asarray(i1), jnp.asarray(i2)))
    got = tfp.dense_flow(_t(i1), _t(i2), interop.flow_params_from_jax(jp)).numpy()
    _assert_flow_close(got[..., 0], got[..., 1], ref[..., 0], ref[..., 1])


def _launch_counts():
    return (kfr.flow_refine.launches, kfr.flow_refine.median_in_launches,
            kfs.flow_refine_small.launches, kfs.flow_refine_small.median_in_launches,
            kfs.guard_select.launches)


def test_cpu_tensors_take_the_plain_versions(scene):
    """On CPU tensors each wrapper returns its plain version's result and
    launches nothing; ``median_in`` refines the median-filtered coarse
    flow; an unsupported device raises."""
    i1, i2, flow = scene
    a, b = _t(i1), _t(i2)
    uc = _t(flow[:, ::2, ::2, 0] * 0.5)
    vc = _t(flow[:, ::2, ::2, 1] * 0.5)
    filtered = kfs.median3x3_uv_plain(uc, vc)
    z = torch.zeros_like(a)
    counts = _launch_counts()
    for got, ref in (
        (kfr.flow_refine(a, b, uc, vc, 5), kfr.flow_refine_plain(a, b, uc, vc, 5)),
        (kfs.flow_refine_small(a, b, uc, vc, 2, 5), kfs.flow_refine_small_plain(a, b, uc, vc, 2, 5)),
        (kfr.flow_refine(a, b, uc, vc, 5, median_in=True),
         kfr.flow_refine_plain(a, b, *filtered, 5)),
        (kfs.flow_refine_small(a, b, uc, vc, 2, 5, median_in=True),
         kfs.flow_refine_small_plain(a, b, *filtered, 2, 5)),
        (kfs.guard_select(a, b, a, b, z, z, 5), kfs.guard_select_plain(a, b, a, b, z, z, 5)),
    ):
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert counts == _launch_counts()
    with pytest.raises(ValueError):
        kfs.guard_select(*(t.to("meta") for t in (a, b, a, b, z, z)), 5)


class _RecordingOps:
    """The pyramid's ops with each call's kind and ``median_in`` recorded."""

    def __init__(self, ops):
        self.calls = []

        def wrap(kind, fn):
            def call(*args, **kwargs):
                self.calls.append((kind, args[0].shape[-2:], kwargs.get("median_in", False)))
                return fn(*args, **kwargs)
            return call

        self.ops = tfp._Ops(*(wrap(k, f) for k, f in zip(tfp._Ops._fields, ops)))


@pytest.mark.parametrize(
    "levels,median_levels,warm,expect",
    [(4, True, True, [False, False, None, True, True, False]),
     (4, False, True, [False, False, None, False, False, False]),
     (3, True, False, [False, True, False]),
     (2, True, True, [False, False, None, False])],
)
def test_median_runs_in_the_next_levels_refine(monkeypatch, levels, median_levels, warm, expect):
    """The 3x3 median after each level >= 2 is no call of its own: the next
    finer level's refine takes it (``median_in``); the coarsest level, its
    guard and the levels after 1 and 0 never do.  The plain path takes the
    same sequence and gives the median-then-refine result."""
    i1, i2, _ = _scene(20, h=128, w=192, batch=1)
    params = tfp.FlowParams(levels=levels, coarse_search=2, median_levels=median_levels,
                            fuse_min_pixels=6000)
    init = None
    if warm:
        init = torch.zeros((1, 32, 48, 2))
    rec = _RecordingOps(tfp._PLAIN_OPS)
    monkeypatch.setattr(tfp, "_PLAIN_OPS", rec.ops)
    got = tfp.dense_flow(_t(i1), _t(i2), params, init_flow=init, plain=True)
    assert [m if kind != "guard" else None for kind, _, m in rec.calls] == expect
    assert tfp.effective_levels(params, 128, 192) == levels
    assert {kind for kind, _, _ in rec.calls} == {"refine_sep", "refine_2d"} | (
        {"guard"} if warm else set())
    assert got.shape == (1, 128, 192, 2) and bool(torch.isfinite(got).all())


def test_grid_sums_match_grid_downsample(scene):
    """The fused finest level's cell sums, finished as the stream does,
    equal grid_downsample_uv on the full-resolution flow (port and JAX):
    one cell partition (grid_scatter_plan_np), float32 summation order only
    (1e-6 in normalized units)."""
    i1, i2, flow = scene
    uc = _t(flow[:, ::2, ::2, 0] * 0.5)
    vc = _t(flow[:, ::2, ::2, 1] * 0.5)
    gw, gh, border = 150, 90, 6
    plan = kfr.build_grid_plan(H, W, gh, gw, border_px=border)
    su, sv = kfr.flow_refine_plain(_t(i1), _t(i2), uc, vc, 5, grid_plan=plan)
    grid = torch.stack([su / (plan.counts * W), sv / (plan.counts * H)], -1)
    grid = grid.index_select(-3, plan.idx_y).index_select(-2, plan.idx_x)
    u, v = kfr.flow_refine_plain(_t(i1), _t(i2), uc, vc, 5)
    ref_t = t_grid_downsample_uv(u, v, gw, gh, norm_wh=(W, H), border_px=border)
    ref_j = np.asarray(
        j_grid_downsample_uv(jnp.asarray(u.numpy()), jnp.asarray(v.numpy()), gw, gh,
                             norm_wh=(W, H), border_px=border)
    )
    np.testing.assert_allclose(grid.numpy(), ref_t.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ref_t.numpy(), ref_j, rtol=0, atol=1e-6)


def _interior_diff(got, ref, m=8):
    d = np.abs(np.asarray(got) - np.asarray(ref))[..., m:-m, m:-m]
    return d.mean(), np.percentile(d, 99)


def test_pallas_flow_refine_interpret_vs_plain():
    """The TPU kernel (interpret mode) against the port's plain version:
    loose bounds (mean < 0.05 px, p99 < 0.3 px away from the border band)
    because the TPU kernel clamps the warp residual to +-7 px around the
    block-mean flow and stores images in bf16, which the port does not."""
    from ofps_tpu.pallas.flow_refine import flow_refine_uv

    i1, i2, flow = _scene(3, h=48, w=256, batch=1)
    uc = flow[:, ::2, ::2, 0] * 0.5
    vc = flow[:, ::2, ::2, 1] * 0.5
    ju, jv = flow_refine_uv(
        jnp.asarray(i1), jnp.asarray(i2), jnp.asarray(uc), jnp.asarray(vc), 1, 5,
        interpret=True, coarse_flow=True, axis_sep=True, out_dtype=jnp.float32,
    )
    tu, tv = kfr.flow_refine_plain(_t(i1), _t(i2), _t(uc), _t(vc), 5)
    for got, ref in ((tu, ju), (tv, jv)):
        mean, p99 = _interior_diff(got.numpy(), ref)
        assert mean < 0.05 and p99 < 0.3, (mean, p99)


def test_pallas_flow_refine_small_interpret_vs_plain():
    """The small TPU kernel with its fused guard and median (interpret
    mode) against the port's refine x2 + guard + median, same loose bounds
    (the TPU guard compares integer-candidate costs, the port the SAD of
    the refined warp)."""
    from ofps_tpu.pallas.flow_refine_small import flow_refine_small_uv

    rng = np.random.default_rng(4)
    h, w = 33, 60
    img = gaussian_filter(rng.standard_normal((1, h + 20, w + 20)), (0, 1.5, 1.5)) * 100
    u0 = (gaussian_filter(rng.standard_normal((1, h, w)), (0, 6, 6)) * 4).astype(np.float32)
    v0 = (gaussian_filter(rng.standard_normal((1, h, w)), (0, 6, 6)) * 3).astype(np.float32)
    i2 = img[:, 10 : 10 + h, 10 : 10 + w].astype(np.float32)
    i1 = np.asarray(j_warp(jnp.asarray(i2), jnp.asarray(np.stack([u0, v0], -1))))
    ju, jv = flow_refine_small_uv(
        jnp.asarray(i1), jnp.asarray(i2), jnp.asarray(u0), jnp.asarray(v0), 2, 5,
        interpret=True, guard_zero_init=True, median_out=True,
    )
    a, b = _t(i1), _t(i2)
    rw = kfs.flow_refine_small_plain(a, b, _t(u0), _t(v0), 2, 5)
    z = torch.zeros_like(a)
    r0 = kfs.flow_refine_small_plain(a, b, z, z, 2, 5)
    tu, tv = kfs.median3x3_uv_plain(*kfs.guard_select_plain(a, b, *rw, *r0, 5))
    for got, ref in ((tu, ju), (tv, jv)):
        mean, p99 = _interior_diff(got.numpy(), ref, m=4)
        assert mean < 0.05 and p99 < 0.3, (mean, p99)


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda():
    """On the card: each kernel against its plain version on the same
    inputs; under 0.1% of pixels may differ by more than 1e-3 px (float32
    near-ties), grid sums within 1e-5 normalized."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    i1, i2, flow = _scene(5, h=135, w=240)
    a, b = _t(i1).to(dev), _t(i2).to(dev)
    uc = _t(flow[:, ::2, ::2, 0] * 0.5).to(dev)
    vc = _t(flow[:, ::2, ::2, 1] * 0.5).to(dev)
    z = torch.zeros_like(a)

    def close(got, ref):
        d = torch.maximum((got[0] - ref[0]).abs(), (got[1] - ref[1]).abs())
        return (d > 1e-3).float().mean().item() < 1e-3

    assert close(kfr.flow_refine(a, b, uc, vc, 5), kfr.flow_refine_plain(a, b, uc, vc, 5))
    for s, (u0, v0) in ((1, (uc, vc)), (4, (z, z))):
        assert close(
            kfs.flow_refine_small(a, b, u0, v0, s, 5),
            kfs.flow_refine_small_plain(a, b, u0, v0, s, 5),
        )
    rw = kfs.flow_refine_small_plain(a, b, uc, vc, 2, 5)
    r0 = kfs.flow_refine_small_plain(a, b, z, z, 2, 5)
    assert close(kfs.guard_select(a, b, *rw, *r0, 5), kfs.guard_select_plain(a, b, *rw, *r0, 5))
    assert close(kfr.flow_refine(a, b, uc, vc, 5, median_in=True),
                 kfr.flow_refine_plain(a, b, *kfs.median3x3_uv_plain(uc, vc), 5))
    plan = kfr.build_grid_plan(135, 240, 84, 150, border_px=4, device=dev)
    got = kfr.flow_refine(a, b, uc, vc, 5, grid_plan=plan)
    ref = kfr.flow_refine_plain(a, b, uc, vc, 5, grid_plan=plan)
    for g, r, n in zip(got, ref, (240, 135)):
        assert ((g - r).abs() / (plan.counts * n)).max().item() <= 1e-5


@pytest.mark.cuda
def test_refine_2d_at_big_levels_on_cuda():
    """On the card: the 2-D sweep kernel at the big-level kernel's 2-D mode
    shapes, 1080x1920 with s=1 from 540x960 flow (``axis_sep=False``) and
    540x960 with s=2 from 270x480 (``search=2``), against its plain
    version: under 0.1% of pixels off by more than 1e-3 px (float32
    near-ties)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for (h, w), s in (((1080, 1920), 1), ((540, 960), 2)):
        i1, i2, flow = _scene(6, h=h, w=w, batch=1)
        a, b = _t(i1).to(dev), _t(i2).to(dev)
        uc = _t(flow[:, ::2, ::2, 0] * 0.5).to(dev)
        vc = _t(flow[:, ::2, ::2, 1] * 0.5).to(dev)
        got = kfs.flow_refine_small(a, b, uc, vc, s, 5)
        ref = kfs.flow_refine_small_plain(a, b, uc, vc, s, 5)
        d = torch.maximum((got[0] - ref[0]).abs(), (got[1] - ref[1]).abs())
        assert (d > 1e-3).float().mean().item() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,h,w,batch,search",
    [("2d", 33, 60, 4, 6), ("2d", 67, 120, 1, 6), ("2d-ties", 33, 60, 1, 6),
     ("2d", 9, 33, 2, 6), ("2d", 33, 65, 2, 1), ("sep", 67, 121, 2, 1),
     ("sep", 65, 129, 2, 1), ("sep-grid", 100, 130, 2, 1),
     ("2d-median", 67, 120, 4, 1), ("sep-median", 135, 240, 4, 1),
     ("sep-median", 270, 480, 4, 1), ("sep-median", 540, 960, 4, 1),
     ("guard", 33, 60, 4, 5), ("guard", 67, 120, 1, 7)],
)
def test_redesigned_kernels_match_plain_on_cuda(kind, h, w, batch, search):
    """On the card: the separable-cost-plane kernels against their plain
    versions at the coarse sweep's shapes (s=6 at 33x60 and 67x120), on the
    tie-heavy scene, and one row or column past their tiles (8x8 and 32x8
    for the 2-D sweep, 64x32 for the axis-separable refine); the serving
    step's four refines that take the fused median (``median_in``, from
    the (h//2, w//2) flow) against the plain median then the plain refine;
    the guard's tiles at the serving step's and the robust LK's shapes
    (``search`` is the guard's window there).  Under 0.1% of pixels off by
    more than 1e-3 px, grid sums within 1e-5 normalized."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    if kind == "2d-ties":
        i1, i2 = _tie_scene(h, w, search)
        uc = vc = np.zeros_like(i1)
    elif kind == "guard":
        i1, i2, flow = _scene(10, h=h, w=w, batch=batch)
        a, b, uw, vw = (_t(x).to(dev) for x in (i1, i2, flow[..., 0], flow[..., 1]))
        z = torch.zeros_like(a)
        got = kfs.guard_select(a, b, uw, vw, z, z, search)
        ref = kfs.guard_select_plain(a, b, uw, vw, z, z, search)
        d = torch.maximum((got[0] - ref[0]).abs(), (got[1] - ref[1]).abs())
        assert (d > 1e-3).float().mean().item() < 1e-3
        return
    else:
        i1, i2, flow = _scene(10, h=h, w=w, batch=batch)
        uc = flow[:, ::2, ::2, 0] * 0.5
        vc = flow[:, ::2, ::2, 1] * 0.5
        if kind.endswith("median"):
            uc, vc = uc[:, : h // 2, : w // 2], vc[:, : h // 2, : w // 2]
    a, b, uc, vc = (_t(x).to(dev) for x in (i1, i2, uc, vc))
    if kind == "sep-median":
        got = kfr.flow_refine(a, b, uc, vc, 5, median_in=True)
        ref = kfr.flow_refine_plain(a, b, *kfs.median3x3_uv_plain(uc, vc), 5)
    elif kind == "2d-median":
        got = kfs.flow_refine_small(a, b, uc, vc, search, 5, median_in=True)
        ref = kfs.flow_refine_small_plain(a, b, *kfs.median3x3_uv_plain(uc, vc), search, 5)
    if kind == "sep-grid":
        plan = kfr.build_grid_plan(h, w, 9, 11, border_px=5, device=dev)
        got = kfr.flow_refine(a, b, uc, vc, 5, grid_plan=plan)
        ref = kfr.flow_refine_plain(a, b, uc, vc, 5, grid_plan=plan)
        for g, r, n in zip(got, ref, (w, h)):
            assert ((g - r).abs() / (plan.counts * n)).max().item() <= 1e-5
        return
    elif kind == "sep":
        got, ref = kfr.flow_refine(a, b, uc, vc, 5), kfr.flow_refine_plain(a, b, uc, vc, 5)
    else:
        got = kfs.flow_refine_small(a, b, uc, vc, search, 5)
        ref = kfs.flow_refine_small_plain(a, b, uc, vc, search, 5)
    d = torch.maximum((got[0] - ref[0]).abs(), (got[1] - ref[1]).abs())
    assert (d > 1e-3).float().mean().item() < 1e-3

