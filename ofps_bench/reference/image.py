# Frozen copy of the port's plain ``ofps_torch/ops/image.py`` (the benchmark's
# reference; it imports nothing of the port).
"""Image ops on ``(..., H, W)`` float32 tensors (port of the subset of
``ofps_tpu.ops.image`` the serving path and the cv decoder run).

Every function reproduces the JAX op's arithmetic order, so the CPU results
agree with ``ofps_tpu`` to float32 rounding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8/float -> (..., H, W) float32 luma (BT.601)."""
    rgb = rgb.to(torch.float32)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling (pyramid downsample); truncates odd edges."""
    h2, w2 = x.shape[-2] // 2, x.shape[-1] // 2
    x = x[..., : h2 * 2, : w2 * 2]
    s = x[..., 0::2, 0::2] + x[..., 0::2, 1::2]
    s = s + x[..., 1::2, 0::2]
    s = s + x[..., 1::2, 1::2]
    return s * 0.25


def build_pyramid(x: torch.Tensor, levels: int):
    """List of ``levels`` images, finest first."""
    pyr = [x.contiguous()]
    for _ in range(levels - 1):
        pyr.append(avg_pool2(pyr[-1]))
    return pyr


@functools.lru_cache(maxsize=None)
def resize_matrix_np(n: int, on: int) -> np.ndarray:
    """(on, n) float32 weights of ``jax.image.resize(..., "bilinear")``.

    Replays jax's ``compute_weight_mat`` in float32: a triangle kernel
    widened by the scale when downsampling (antialias, jax's default),
    columns normalised to sum 1, and samples outside the input zeroed.  For
    upsampling this is plain half-pixel bilinear interpolation with edge
    clamping, the matrix ``ofps_tpu.ops.image._interp_matrix`` builds.
    """
    if n == on:
        return np.eye(n, dtype=np.float32)
    inv_scale = np.float32(1.0 / (on / n))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (
        (np.arange(on, dtype=np.float32) + np.float32(0.5)) * inv_scale
        - np.float32(0.5)
    )
    x = np.abs(sample_f[None, :] - np.arange(n, dtype=np.float32)[:, None])
    x = (x / kernel_scale).astype(np.float32)
    wts = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = wts.sum(axis=0, keepdims=True, dtype=np.float32)
    wts = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        wts / np.where(total != 0, total, np.float32(1.0)),
        np.float32(0.0),
    )
    inside = (sample_f >= -0.5) & (sample_f <= n - 0.5)
    wts = np.where(inside[None, :], wts, np.float32(0.0))
    return np.ascontiguousarray(wts.T.astype(np.float32))


@functools.lru_cache(maxsize=64)
def _resize_matrix(n: int, on: int, device: str) -> torch.Tensor:
    return torch.from_numpy(resize_matrix_np(n, on)).to(device)


def resize_bilinear(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """``jax.image.resize(x, (..., oh, ow), "bilinear")`` as two matmuls."""
    h, w = x.shape[-2], x.shape[-1]
    if h != oh:
        x = torch.matmul(_resize_matrix(h, oh, str(x.device)), x)
    if w != ow:
        x = torch.matmul(x, _resize_matrix(w, ow, str(x.device)).T)
    return x


@functools.lru_cache(maxsize=None)
def _interp_matrix_np(n: int, on: int) -> np.ndarray:
    """(on, n) two-tap bilinear interpolation matrix (half-pixel centres,
    edge clamp), as ``ofps_tpu.ops.image._interp_matrix`` builds it.  Unlike
    :func:`resize_matrix_np` it never widens the kernel when downsampling."""
    idx = np.arange(on)
    src = (idx + 0.5) * (n / on) - 0.5
    lo = np.clip(np.floor(src).astype(int), 0, n - 1)
    hi = np.clip(lo + 1, 0, n - 1)
    whi = np.clip(src - lo, 0.0, 1.0)
    m = np.zeros((on, n), np.float32)
    m[idx, lo] += 1.0 - whi
    m[idx, hi] += whi
    return m


@functools.lru_cache(maxsize=64)
def _interp_matrix(n: int, on: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_interp_matrix_np(n, on)).to(device)


def resize_bilinear_matmul(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Bilinear resize of (..., H, W) as two matmuls with the two-tap
    matrix (``ofps_tpu.ops.image.resize_bilinear_matmul``): rows first."""
    h, w = x.shape[-2], x.shape[-1]
    y = torch.matmul(_interp_matrix(h, oh, str(x.device)), x)
    return torch.matmul(y, _interp_matrix(w, ow, str(x.device)).T)


def shift2d(x: torch.Tensor, dx: int, dy: int, fill: float = 0.0) -> torch.Tensor:
    """out[..., y, x] = in[..., y + dy, x + dx] with constant fill."""
    h, w = x.shape[-2], x.shape[-1]
    padded = F.pad(
        x, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)), value=fill
    )
    sy, sx = max(dy, 0), max(dx, 0)
    return padded[..., sy : sy + h, sx : sx + w]


def box_filter(x: torch.Tensor, win: int) -> torch.Tensor:
    """Separable (win x win) mean filter with zero padding at borders."""
    r = win // 2
    out = torch.zeros_like(x)
    for d in range(-r, r + 1):
        out = out + shift2d(x, d, 0)
    out2 = torch.zeros_like(out)
    for d in range(-r, r + 1):
        out2 = out2 + shift2d(out, 0, d)
    return out2 / float(win * win)


_SOBEL_D5 = (-1.0, -2.0, 0.0, 2.0, 1.0)


def sobel_xy(x: torch.Tensor) -> torch.Tensor:
    """Mixed derivative d/dx d/dy with the 5-tap [-1, -2, 0, 2, 1] in both
    axes (zero-filled shifts; the zero tap is kept, as the JAX op keeps
    it)."""
    out = torch.zeros_like(x)
    for i, k in enumerate(_SOBEL_D5):
        out = out + k * shift2d(x, i - 2, 0)
    out2 = torch.zeros_like(out)
    for i, k in enumerate(_SOBEL_D5):
        out2 = out2 + k * shift2d(out, 0, i - 2)
    return out2


def dilate_disk(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Binary dilation with a disk structuring element (zero outside)."""
    acc = torch.zeros_like(mask)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dx * dx + dy * dy <= radius * radius:
                acc = torch.maximum(acc, shift2d(mask, dx, dy))
    return acc


def warp_bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` at (x + u, y + v): backward warp with border clamping.

    ``img``, ``u``, ``v``: (..., H, W) with matching shapes (flow in pixels,
    split into components).
    """
    h, w = img.shape[-2], img.shape[-1]
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    sx = torch.clamp(xs + u, 0.0, w - 1.0)
    sy = torch.clamp(ys + v, 0.0, h - 1.0)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    flat = img.reshape(img.shape[:-2] + (h * w,))

    def gather(yy, xx):
        idx = (yy * w + xx).reshape(flat.shape)
        return torch.gather(flat, -1, idx).reshape(img.shape)

    return (
        gather(y0, x0) * (1 - fx) * (1 - fy)
        + gather(y0, x1) * fx * (1 - fy)
        + gather(y1, x0) * (1 - fx) * fy
        + gather(y1, x1) * fx * fy
    )


def median3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 median filter with edge clamping (exact: the median of 9)."""
    h, w = x.shape[-2], x.shape[-1]
    lead = x.shape[:-2]
    xp = F.pad(x.reshape((-1, 1, h, w)), (1, 1, 1, 1), mode="replicate")
    taps = torch.stack(
        [xp[..., dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)]
    )
    return taps.median(dim=0).values.reshape(lead + (h, w))
