"""Bilinear backward warp (kernel ``csrc/warp.cu``, replacing
``ofps_tpu/pallas/warp.py``'s ``_warp_kernel``) and its plain PyTorch
version.

The kernel computes :func:`ofps_torch.ops.image.warp_bilinear` exactly: it
samples at each pixel's own flow, without the TPU kernel's block-mean base
offset and +-7 px residual clamp.  Bound by bytes on the H100 (16 B per
pixel in and out).
"""

from __future__ import annotations

import torch

from ofps_torch.kernels import build
from ofps_torch.ops import image


def warp_bilinear_plain(img, u, v):
    """Plain PyTorch version of :func:`warp_bilinear`, on any device."""
    return image.warp_bilinear(img, u, v)


def warp_bilinear(img, u, v):
    """Sample ``img`` at (x + u, y + v), coordinates clamped to the image.

    ``img``, ``u``, ``v``: (..., H, W) float32 of one shape (flow in
    pixels).  CPU tensors run :func:`warp_bilinear_plain`; CUDA tensors
    launch the kernel.
    """
    if not build.on_cuda("warp_bilinear", img):
        return warp_bilinear_plain(img, u, v)
    build.require_cuda_f32("warp_bilinear", img, u, v)
    if u.shape != img.shape or v.shape != img.shape or img.dim() < 2:
        raise ValueError("warp_bilinear: img, u and v must be (..., H, W) of one shape")
    h, w = img.shape[-2], img.shape[-1]
    out = torch.empty_like(img)
    with build.on_device(img.device):
        status = build.library().ofps_warp_bilinear(
            img.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(),
            img.numel() // (h * w), h, w, build.stream_ptr(img.device),
        )
    build.check(status, "ofps_warp_bilinear")
    warp_bilinear.launches += 1
    return out


warp_bilinear.launches = 0
