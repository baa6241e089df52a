"""Parity of the port's robust dense LK (ofps_torch.ops.flow_lk) and its
warp kernel's plain version (ofps_torch.kernels.warp) with ofps_tpu.

On the CPU the JAX package's ``_warp`` takes the exact XLA warp (the Pallas
warp runs only on a TPU), which is what the port computes on every device.
Tolerances: the warp is exact (same expression order); the LK flow within
1e-4 px (float32 rounding through 3 levels x 3 iterations of box sums and
2x2 solves; the observed difference is ~1e-5 px).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from ofps_torch import interop
from ofps_torch.kernels import flow_refine_small as kfs
from ofps_torch.kernels import warp as kwarp
from ofps_torch.ops import flow_lk as tlk
from ofps_torch.ops.flow_pyramid import _warp
from ofps_tpu.ops import flow_lk as jlk
from ofps_tpu.ops.image import warp_bilinear as j_warp

H, W = 96, 128
LK_TOL = 1e-4  # px


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _texture(rng, shape, sigma=2.0):
    return (gaussian_filter(rng.standard_normal(shape), sigma) * 300).astype(np.float32)


def _smooth_flow(rng, shape, sigma, amp, offset=(0.0, 0.0)):
    f = gaussian_filter(rng.standard_normal(shape + (2,)), (sigma,) * len(shape) + (0,))
    return (f / np.abs(f).max() * amp + np.asarray(offset)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """i1(x, y) = i2(x - 2, y + 1): a textured 96 x 128 pair, flow (-2, 1)."""
    img = _texture(np.random.default_rng(0), (H + 40, W + 40))
    return img[21 : 21 + H, 18 : 18 + W].copy(), img[20 : 20 + H, 20 : 20 + W].copy()


@pytest.mark.parametrize("amp", [3.0, 40.0, 150.0])
def test_warp_kernel_on_cpu_matches_jax(amp):
    """The wrapper on CPU tensors (its plain version) equals the JAX warp,
    also where the flow leaves the image (amp 40 and 150 px) and the
    coordinates clamp; no kernel is launched."""
    rng = np.random.default_rng(1)
    img = _texture(rng, (2, 48, 80), (0, 2, 2))
    flow = _smooth_flow(rng, (2, 48, 80), 6, amp)
    launches = kwarp.warp_bilinear.launches
    got = kwarp.warp_bilinear(_t(img), _t(flow[..., 0]), _t(flow[..., 1]))
    ref = np.asarray(j_warp(jnp.asarray(img), jnp.asarray(flow)))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert kwarp.warp_bilinear.launches == launches
    np.testing.assert_array_equal(
        _warp(_t(img), _t(flow[..., 0]), _t(flow[..., 1]), plain=True).numpy(), ref
    )


def test_gradients_exact(pair):
    i1, _ = pair
    jx, jy = jlk._gradients(jnp.asarray(i1))
    tx, ty = tlk._gradients(_t(i1))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_lk_level_matches(pair):
    i1, i2 = pair
    init = _smooth_flow(np.random.default_rng(2), (H, W), 8, 1.5, (-2.0, 1.0))
    ju, jv = jax.jit(lambda a, b, u, v: jlk._lk_level(a, b, u, v, jlk.LKParams(), False))(
        jnp.asarray(i1), jnp.asarray(i2), jnp.asarray(init[..., 0]), jnp.asarray(init[..., 1])
    )
    tu, tv = tlk._lk_level(_t(i1), _t(i2), _t(init[..., 0]), _t(init[..., 1]), tlk.LKParams())
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=LK_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=LK_TOL)


@pytest.mark.parametrize("warm", [False, True])
def test_dense_flow_lk_matches(pair, warm):
    """3 levels, cold and warm started; the warm start runs the coarsest
    level from both inits and the SAD guard picks per pixel.  The shift
    (-2, 1) is recovered in the interior."""
    i1, i2 = pair
    jp = jlk.LKParams(levels=3)
    init = _smooth_flow(np.random.default_rng(3), (H, W), 8, 3.0, (-2.0, 1.0)) if warm else None
    ref = np.asarray(
        jax.jit(lambda a, b, f: jlk.dense_flow_lk(a, b, jp, init_flow=f))(
            jnp.asarray(i1), jnp.asarray(i2), None if init is None else jnp.asarray(init)
        )
    )
    got = tlk.dense_flow_lk(
        _t(i1), _t(i2), interop.lk_params_from_jax(jp), None if init is None else _t(init)
    ).numpy()
    assert got.shape == (H, W, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=LK_TOL)
    med = np.median(got[8:-8, 8:-8], axis=(0, 1))
    np.testing.assert_allclose(med, [-2.0, 1.0], atol=0.05)


def test_lk_guard_keeps_warm_on_ties(pair):
    """The coarse guard LK races its inits through (``guard_select``, on a
    2-D LK level) keeps the warm solution where both SADs tie and takes
    the zero-init one where it is strictly better."""
    i1, i2 = pair
    a, b = _t(i1), _t(i2)
    good_u, good_v = torch.full_like(a, -2.0), torch.full_like(a, 1.0)
    u, v = kfs.guard_select(a, b, good_u, good_v, good_u, good_v, 7)
    assert torch.equal(u, good_u) and torch.equal(v, good_v)
    u, _ = kfs.guard_select(a, b, torch.full_like(a, 5.0), good_v, good_u, good_v, 7)
    assert (u[8:-8, 8:-8] == -2.0).all()


@pytest.mark.cuda
def test_warp_kernel_matches_plain_on_cuda():
    """On the card: the kernel against its plain version at two LK level
    shapes, B=1 and B=3, flows inside and leaving the image.  The library is
    built with -fmad=false and keeps the plain operand order: within 1e-5
    (expected bit-exact)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    for shape in ((1, 67, 120), (3, 270, 480)):
        img = _t(_texture(rng, shape, (0, 2, 2))).to(dev)
        for amp in (3.0, 150.0):
            f = _smooth_flow(rng, shape, 6, amp)
            u, v = _t(f[..., 0]).to(dev), _t(f[..., 1]).to(dev)
            n = kwarp.warp_bilinear.launches
            got = kwarp.warp_bilinear(img, u, v)
            ref = kwarp.warp_bilinear_plain(img, u, v)
            torch.cuda.synchronize()
            assert kwarp.warp_bilinear.launches == n + 1
            assert (got - ref).abs().max().item() <= 1e-5
