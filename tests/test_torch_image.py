"""Parity of the port's image ops (ofps_torch.ops.image) with ofps_tpu.

Inputs are made with numpy from a seed and fed to both packages.  The ops
repeat the JAX package's arithmetic order, so most agree to float32
rounding: pyramid, box filter, resize and warp within 1e-4 on the 0-255
scale; the median is exact (it selects one of its inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from ofps_torch.ops import image as timg
from ofps_tpu.ops import image as jimg
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# Image-value tolerance on the 0-255 scale: float32 reassociation only.
TOL_IMG = 1e-4


def _image(seed, shape):
    rng = np.random.default_rng(seed)
    img = gaussian_filter(rng.standard_normal(shape).astype(np.float32), 2.0)
    return (img / np.abs(img).max() * 127.0 + 128.0).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def test_pyramid_matches():
    img = _image(0, (2, 96, 160))
    jp = jimg.build_pyramid(jnp.asarray(img), 4)
    tp = timg.build_pyramid(_t(img), 4)
    assert [tuple(x.shape) for x in tp] == [tuple(x.shape) for x in jp]
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=TOL_IMG)


@pytest.mark.parametrize("win", [3, 5])
def test_box_filter_matches(win):
    img = _image(1, (2, 40, 56))
    ref = np.asarray(jimg.box_filter(jnp.asarray(img), win))
    np.testing.assert_allclose(
        timg.box_filter(_t(img), win).numpy(), ref, rtol=0, atol=TOL_IMG
    )


@pytest.mark.parametrize("dx,dy", [(2, -1), (-3, 0), (0, 4)])
def test_shift2d_matches(dx, dy):
    img = _image(2, (24, 40))
    ref = np.asarray(jimg.shift2d(jnp.asarray(img), dx, dy, fill=-1.0))
    np.testing.assert_array_equal(timg.shift2d(_t(img), dx, dy, fill=-1.0).numpy(), ref)


@pytest.mark.parametrize("shape,out", [((48, 80), (96, 160)), ((67, 120), (135, 240))])
def test_resize_upsample_matches_interp_matmul(shape, out):
    """Flow upsampling: the port's resize (jax.image.resize weights, as the
    XLA path's upsample2_flow) and resize_bilinear_matmul (the TPU path's)
    agree within 2e-5 on unit-variance flow values; the TPU matrix places
    its samples in float64, jax in float32."""
    x = np.random.default_rng(3).standard_normal((2,) + shape).astype(np.float32)
    ref = np.asarray(jimg.resize_bilinear_matmul(jnp.asarray(x), *out))
    np.testing.assert_allclose(
        timg.resize_bilinear(_t(x), *out).numpy(), ref, rtol=0, atol=2e-5
    )


@pytest.mark.parametrize(
    "shape,out", [((540, 960), (33, 60)), ((48, 80), (12, 20)), ((67, 120), (135, 240))]
)
def test_resize_matches_jax_image_resize(shape, out):
    """The warm-init downsample is jax.image.resize (antialiased triangle
    kernel), not the plain interpolation matrix: agree within 1e-5 on
    unit-variance noise (float32 weight arithmetic only)."""
    x = np.random.default_rng(4).standard_normal((2,) + shape).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2,) + out, "bilinear"))
    got = timg.resize_bilinear(_t(x), *out).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_resize_matrix_rows_match_jax_weights():
    """The numpy weight matrix is jax's: resizing the identity reproduces it."""
    n, on = 60, 33
    eye = jnp.eye(n, dtype=jnp.float32)
    ref = np.asarray(jax.image.resize(eye, (on, n), "bilinear"))
    np.testing.assert_allclose(timg.resize_matrix_np(n, on), ref, rtol=0, atol=1e-7)


def test_warp_bilinear_matches():
    img = _image(5, (2, 48, 80))
    rng = np.random.default_rng(6)
    flow = (gaussian_filter(rng.standard_normal((2, 48, 80, 2)), (0, 6, 6, 0)) * 40).astype(
        np.float32
    )
    ref = np.asarray(jimg.warp_bilinear(jnp.asarray(img), jnp.asarray(flow)))
    got = timg.warp_bilinear(_t(img), _t(flow[..., 0]), _t(flow[..., 1])).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL_IMG)


def test_median3x3_exact():
    x = np.random.default_rng(7).standard_normal((2, 33, 60)).astype(np.float32)
    ref = np.asarray(jimg.median3x3(jnp.asarray(x)))
    np.testing.assert_array_equal(timg.median3x3(_t(x)).numpy(), ref)


def test_rgb_to_gray_exact():
    rgb = np.random.default_rng(8).integers(0, 256, (2, 24, 40, 3)).astype(np.uint8)
    ref = np.asarray(jimg.rgb_to_gray(jnp.asarray(rgb)))
    np.testing.assert_array_equal(timg.rgb_to_gray(torch.from_numpy(rgb)).numpy(), ref)


def test_sobel_xy_exact():
    """Same taps in the same order, zero tap and zero fill included."""
    img = _image(9, (2, 40, 56))
    ref = np.asarray(jimg.sobel_xy(jnp.asarray(img)))
    np.testing.assert_array_equal(timg.sobel_xy(_t(img)).numpy(), ref)


@pytest.mark.parametrize("radius", [1, 2])
def test_dilate_disk_exact(radius):
    mask = (np.random.default_rng(10).random((2, 40, 56)) > 0.97).astype(np.float32)
    ref = np.asarray(jimg.dilate_disk(jnp.asarray(mask), radius))
    np.testing.assert_array_equal(timg.dilate_disk(_t(mask), radius).numpy(), ref)


@pytest.mark.parametrize(
    "shape,out", [((96, 128), (24, 32)), ((540, 960), (33, 60)), ((48, 64), (96, 128))]
)
def test_resize_bilinear_matmul_matches(shape, out):
    """The two-tap matrix resize (the LK warm-start downsample and its
    inter-level upsample) equals the JAX op; on a large downsample it is NOT
    the antialiased ``resize_bilinear`` (they differ by > 1 on unit noise)."""
    x = np.random.default_rng(11).standard_normal((2,) + shape).astype(np.float32)
    ref = np.asarray(jimg.resize_bilinear_matmul(jnp.asarray(x), *out))
    np.testing.assert_allclose(
        timg.resize_bilinear_matmul(_t(x), *out).numpy(), ref, rtol=0, atol=1e-6
    )
    if out[0] * 4 <= shape[0]:
        assert np.abs(timg.resize_bilinear(_t(x), *out).numpy() - ref).max() > 1.0
