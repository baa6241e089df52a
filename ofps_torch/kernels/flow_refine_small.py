"""Full 2-D flow refine and warm/zero guard (kernels in
``csrc/flow_refine_small.cu``, replacing ``ofps_tpu/pallas/
flow_refine_small.py``'s ``_small_kernel`` with its fused guard and median)
and their plain PyTorch versions.

The Pallas kernel fused three steps into one launch.  Here the (2s+1)^2
sweep runs once from the warm init and once from zero, ``guard_select``
keeps the per-pixel winner, and the 3x3 median of the result runs inside
the next level's refine (``median_in=True`` of :func:`flow_refine_small`
and :func:`ofps_torch.kernels.flow_refine.flow_refine`), in the staging of
its upsample.  The robust LK's coarsest level races its warm and zero
inits through the same ``guard_select``.
"""

from __future__ import annotations

import torch

from ofps_torch.kernels import build
from ofps_torch.ops.image import median3x3, resize_bilinear, warp_bilinear


def flow_refine_small_plain(i1, i2, u, v, search: int, win: int,
                            cost_dtype=torch.bfloat16, median_in: bool = False):
    """Plain PyTorch version of :func:`flow_refine_small`, on any device."""
    from ofps_torch.ops.flow_pyramid import _level_refine

    if median_in:
        u, v = median3x3_uv_plain(u, v)
    h, w = i1.shape[-2], i1.shape[-1]
    if u.shape[-2:] != (h, w):
        u = resize_bilinear(u, h, w) * 2.0
        v = resize_bilinear(v, h, w) * 2.0
    du, dv = _level_refine(i1, warp_bilinear(i2, u, v), search, win, cost_dtype)
    return u + du, v + dv


def flow_refine_small(i1, i2, u, v, search: int, win: int,
                      cost_dtype=torch.bfloat16, median_in: bool = False):
    """Refine one level with the full (2s+1)^2 sweep (two-phase strict-<
    argmin in dy-outer order, per-axis parabola).

    ``i1``, ``i2``: (B, h, w); ``u``, ``v``: (B, hc, wc), the coarser
    level's flow (upsampled 2x in the kernel) or already at (h, w);
    ``median_in``: refine from the 3x3 median (edge clamp) of ``(u, v)``
    instead.  Returns the refined (B, h, w) ``(u, v)``.
    """
    if not build.on_cuda("flow_refine_small", i1):
        return flow_refine_small_plain(i1, i2, u, v, search, win, cost_dtype, median_in)
    if cost_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flow_refine_small: unsupported cost_dtype {cost_dtype}")
    if win not in build.KERNEL_WINDOWS:
        raise ValueError(f"flow_refine_small: the kernel takes win in {build.KERNEL_WINDOWS}, not {win}")
    build.require_cuda_f32("flow_refine_small", i1, i2, u, v)
    bsz, h, w = i1.shape
    hc, wc = u.shape[-2:]
    if i2.shape != i1.shape or u.shape != (bsz, hc, wc) or v.shape != u.shape:
        raise ValueError("flow_refine_small: shape mismatch")
    yi, yw, xi, xw, scale = build.upsample_taps(hc, wc, h, w, str(i1.device))
    u_out, v_out = torch.empty_like(i1), torch.empty_like(i1)
    with build.on_device(i1.device):
        status = build.library().ofps_flow_refine_small(
            i1.data_ptr(), i2.data_ptr(), u.data_ptr(), v.data_ptr(),
            yi.data_ptr(), yw.data_ptr(), xi.data_ptr(), xw.data_ptr(), scale,
            u_out.data_ptr(), v_out.data_ptr(), bsz, h, w, hc, wc, search, win,
            int(cost_dtype == torch.bfloat16), int(median_in), build.stream_ptr(i1.device),
        )
    build.check(status, "ofps_flow_refine_small")
    flow_refine_small.launches += 1
    flow_refine_small.median_in_launches += int(median_in)
    return u_out, v_out


flow_refine_small.launches = 0
flow_refine_small.median_in_launches = 0  # launches that took the fused median


def guard_select_plain(a, b, u_w, v_w, u_0, v_0, win: int):
    """Plain PyTorch version of :func:`guard_select`, on any device."""
    from ofps_torch.ops.flow_pyramid import _coarse_guard

    return _coarse_guard(a, b, u_w, v_w, u_0, v_0, win)


def guard_select(a, b, u_w, v_w, u_0, v_0, win: int):
    """Per pixel, keep the warm-init solution ``(u_w, v_w)`` unless the
    zero-init one has a strictly smaller box-mean SAD of ``|a - warp(b)|``
    at its refined flow.  All (..., h, w) of one shape."""
    if not build.on_cuda("guard_select", a):
        return guard_select_plain(a, b, u_w, v_w, u_0, v_0, win)
    build.require_cuda_f32("guard_select", a, b, u_w, v_w, u_0, v_0)
    if a.dim() < 2 or not all(t.shape == a.shape for t in (b, u_w, v_w, u_0, v_0)):
        raise ValueError("guard_select: shape mismatch")
    h, w = a.shape[-2:]
    bsz = a.numel() // (h * w)
    u_out, v_out = torch.empty_like(a), torch.empty_like(a)
    with build.on_device(a.device):
        status = build.library().ofps_guard_select(
            a.data_ptr(), b.data_ptr(), u_w.data_ptr(), v_w.data_ptr(),
            u_0.data_ptr(), v_0.data_ptr(), u_out.data_ptr(), v_out.data_ptr(),
            bsz, h, w, win, build.stream_ptr(a.device),
        )
    build.check(status, "ofps_guard_select")
    guard_select.launches += 1
    return u_out, v_out


guard_select.launches = 0


def median3x3_uv_plain(u, v):
    """3x3 median (edge clamp) of both flow planes: what ``median_in``
    applies to the coarser flow, on any device."""
    return median3x3(u), median3x3(v)
