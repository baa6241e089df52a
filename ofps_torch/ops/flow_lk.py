"""Robust dense pyramidal Lucas-Kanade optical flow (port of
``ofps_tpu.ops.flow_lk``, the cv decoder's ``use_rlof`` algorithm).

At every pixel, ``iters`` Gauss-Newton steps per pyramid level solve the
2x2 local LK system built from box-filtered structure-tensor and mismatch
maps, with Geman-McClure weights on the temporal residual.  Each step warps
``i2`` by the current flow through the warp kernel
(:mod:`ofps_torch.kernels.warp`); the coarsest level's warm/zero race
runs the block matcher's guard kernel (``guard_select``); everything else
is plain PyTorch.

The JAX package's arithmetic order is kept (so the CPU results agree to
float32 rounding) with one deliberate difference on the TPU: the JAX
package's Pallas warp clamps the per-pixel residual to +-7 px around its
block's mean flow, which the port's warp does not.

Flow travels as split ``(u, v)`` planes; only :func:`dense_flow_lk` packs
it as ``(..., H, W, 2)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ofps_torch.kernels import flow_refine_small as kfs
from ofps_torch.ops.flow_pyramid import _warp, effective_levels
from ofps_torch.ops.image import box_filter, build_pyramid, resize_bilinear_matmul


class LKParams(NamedTuple):
    levels: int = 6
    win: int = 7  # local aggregation window
    iters: int = 3  # LK iterations per pyramid level
    min_level_size: int = 16
    # Geman-McClure scale (gray levels): residuals >> sigma lose influence.
    sigma: float = 12.0
    max_step: float = 1.0  # per-iteration displacement clamp (px)
    eps: float = 1e-4  # structure-tensor regularizer
    # Warm-start guard: race the coarsest level's warm init against a zero
    # init and keep the per-pixel SAD winner.
    guarded_warm: bool = True


def _gradients(img: torch.Tensor):
    """Central-difference gradients with edge replication."""
    right = torch.cat([img[..., :, 1:], img[..., :, -1:]], dim=-1)
    left = torch.cat([img[..., :, :1], img[..., :, :-1]], dim=-1)
    down = torch.cat([img[..., 1:, :], img[..., -1:, :]], dim=-2)
    up = torch.cat([img[..., :1, :], img[..., :-1, :]], dim=-2)
    return 0.5 * (right - left), 0.5 * (down - up)


def _lk_level(i1, i2, u, v, p: LKParams, plain: bool = False):
    """``p.iters`` robust LK updates of ``(u, v)`` at one pyramid level."""
    # A tensor numerator: ``float / tensor`` would multiply by the
    # reciprocal, which rounds differently from the JAX package's division.
    sig2 = torch.tensor(p.sigma * p.sigma, dtype=torch.float32, device=i1.device)
    for _ in range(p.iters):
        warped = _warp(i2, u, v, plain)
        ix, iy = _gradients(warped)
        it = warped - i1
        # Geman-McClure influence: w = sigma^2 / (sigma^2 + r^2).
        rw = sig2 / (sig2 + it * it)
        gxx = box_filter(ix * ix * rw, p.win)
        gxy = box_filter(ix * iy * rw, p.win)
        gyy = box_filter(iy * iy * rw, p.win)
        bx = box_filter(ix * it * rw, p.win)
        by = box_filter(iy * it * rw, p.win)
        tr = gxx + gyy
        det = gxx * gyy - gxy * gxy + p.eps * tr * tr + 1e-20
        du = -(gyy * bx - gxy * by) / det
        dv = -(gxx * by - gxy * bx) / det
        u = u + torch.clamp(du, -p.max_step, p.max_step)
        v = v + torch.clamp(dv, -p.max_step, p.max_step)
    return u, v


def dense_flow_lk(
    i1: torch.Tensor,
    i2: torch.Tensor,
    params: LKParams = LKParams(),
    init_flow: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> torch.Tensor:
    """Dense robust-LK flow i1 -> i2 in pixels.

    ``i1``, ``i2``: (..., H, W) float32; returns (..., H, W, 2).
    ``init_flow``: optional full-resolution (..., H, W, 2) warm start,
    resized to the coarsest level with the two-tap matrix.  With a warm
    start (and ``guarded_warm``) the coarsest level is solved from both the
    warm and a zero init and the per-pixel winner by the box-mean SAD of
    the warp is kept (ties keep the warm one).  ``plain=True`` runs the
    kernels' plain versions on any device.
    """
    levels = effective_levels(params, i1.shape[-2], i1.shape[-1])
    pyr1 = build_pyramid(i1, levels)
    pyr2 = build_pyramid(i2, levels)

    u = v = None
    if init_flow is not None:
        h, w = pyr1[-1].shape[-2], pyr1[-1].shape[-1]
        scale = h / i1.shape[-2]
        u = resize_bilinear_matmul(init_flow[..., 0], h, w) * scale
        v = resize_bilinear_matmul(init_flow[..., 1], h, w) * scale

    for lvl in range(levels - 1, -1, -1):
        a, b = pyr1[lvl], pyr2[lvl]
        h, w = a.shape[-2], a.shape[-1]
        if u is None:
            u = torch.zeros_like(a)
            v = torch.zeros_like(a)
        elif u.shape[-2:] != (h, w):
            u = resize_bilinear_matmul(u, h, w) * 2.0
            v = resize_bilinear_matmul(v, h, w) * 2.0
        if lvl == levels - 1 and init_flow is not None and params.guarded_warm:
            u_w, v_w = _lk_level(a, b, u, v, params, plain)
            zero = torch.zeros_like(u)
            u_0, v_0 = _lk_level(a, b, zero, zero, params, plain)
            guard = kfs.guard_select_plain if plain else kfs.guard_select
            u, v = guard(a, b, u_w, v_w, u_0, v_0, params.win)
        else:
            u, v = _lk_level(a, b, u, v, params, plain)
    return torch.stack([u, v], dim=-1)
