"""Axis-separable flow refine for the large pyramid levels (kernel
``csrc/flow_refine.cu``, replacing ``ofps_tpu/pallas/flow_refine.py``'s
``_refine_kernel``) and its plain PyTorch version.

One level: bilinear 2x upsample of the coarse flow (``median_in``: of its
3x3 median, taken in the kernel's staging), exact bilinear warp of ``i2``,
the 5-cost search-1 cross with a per-axis parabola, and either the refined
full-resolution ``(u, v)`` or, with a :class:`GridPlan`, the scatter-sum of
the refined flow into the serving grid's cells.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ofps_torch.core.motion import grid_scatter_plan_np
from ofps_torch.kernels import build
from ofps_torch.ops.image import median3x3, resize_bilinear, warp_bilinear


class GridPlan(NamedTuple):
    """Static pieces of the grid densify of a (h, w) finest level.

    ``cell_y``/``cell_x``: (h,)/(w,) int32 cell index of each row/column,
    -1 inside the excluded border band (what the kernel reads);
    ``sy``/``sx``: the same partition as one-hot (h, gh)/(w, gw) matrices
    (what the plain version multiplies by); ``counts``: (gh, gw) valid
    pixels per cell (floored at 1); ``idx_y``/``idx_x``: nearest-valid-cell
    replicate gathers, or None without a border band.
    """

    cell_y: torch.Tensor
    cell_x: torch.Tensor
    sy: torch.Tensor
    sx: torch.Tensor
    counts: torch.Tensor
    idx_y: Optional[torch.Tensor]
    idx_x: Optional[torch.Tensor]
    gh: int
    gw: int


def build_grid_plan(h: int, w: int, gh: int, gw: int, border_px: int = 0,
                    device="cpu") -> GridPlan:
    """Grid plan from :func:`ofps_torch.core.motion.grid_scatter_plan_np`,
    so the fused sums and ``grid_downsample_uv`` share one partition."""
    sy, sx, counts, idx_y, idx_x = grid_scatter_plan_np(h, w, gh, gw, border_px)

    def cells(s):
        return np.where(s.sum(axis=1) > 0, s.argmax(axis=1), -1).astype(np.int32)

    def t(a):
        return None if a is None else torch.from_numpy(np.asarray(a)).to(device)

    return GridPlan(
        t(cells(sy)), t(cells(sx)), t(sy), t(sx), t(counts),
        t(idx_y), t(idx_x), gh, gw,
    )


def grid_sums_plain(u: torch.Tensor, plan: GridPlan) -> torch.Tensor:
    """(B, gh, gw) scatter-sums ``syᵀ · u · sx`` of a (B, h, w) plane."""
    return plan.sy.T @ (u @ plan.sx)


def flow_refine_plain(i1, i2, u, v, win: int, cost_dtype=torch.bfloat16,
                      grid_plan: Optional[GridPlan] = None, median_in: bool = False):
    """Plain PyTorch version of :func:`flow_refine`, on any device."""
    from ofps_torch.ops.flow_pyramid import _level_refine

    if median_in:
        u, v = median3x3(u), median3x3(v)
    h, w = i1.shape[-2], i1.shape[-1]
    if u.shape[-2:] != (h, w):
        u = resize_bilinear(u, h, w) * 2.0
        v = resize_bilinear(v, h, w) * 2.0
    du, dv = _level_refine(
        i1, warp_bilinear(i2, u, v), 1, win, cost_dtype, axis_sep=True
    )
    u, v = u + du, v + dv
    if grid_plan is not None:
        return grid_sums_plain(u, grid_plan), grid_sums_plain(v, grid_plan)
    return u, v


def flow_refine(i1, i2, u, v, win: int, cost_dtype=torch.bfloat16,
                grid_plan: Optional[GridPlan] = None, median_in: bool = False):
    """Refine one large level with search 1, axis-separable.

    ``i1``, ``i2``: (B, h, w) float32 level images; ``u``, ``v``: (B, hc,
    wc) flow, either the coarser level's (upsampled 2x in the kernel) or
    already at (h, w); ``median_in``: refine from the 3x3 median (edge
    clamp) of ``(u, v)`` instead.  Returns the refined (B, h, w) ``(u,
    v)``, or the (B, gh, gw) cell sums of each when ``grid_plan`` is given.
    CPU tensors run :func:`flow_refine_plain`; CUDA tensors launch the
    kernel.
    """
    if not build.on_cuda("flow_refine", i1):
        return flow_refine_plain(i1, i2, u, v, win, cost_dtype, grid_plan, median_in)
    if cost_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flow_refine: unsupported cost_dtype {cost_dtype}")
    if win not in build.KERNEL_WINDOWS:
        raise ValueError(f"flow_refine: the kernel takes win in {build.KERNEL_WINDOWS}, not {win}")
    build.require_cuda_f32("flow_refine", i1, i2, u, v)
    bsz, h, w = i1.shape
    hc, wc = u.shape[-2:]
    if i2.shape != i1.shape or u.shape != (bsz, hc, wc) or v.shape != u.shape:
        raise ValueError("flow_refine: shape mismatch")
    yi, yw, xi, xw, scale = build.upsample_taps(hc, wc, h, w, str(i1.device))
    if grid_plan is None:
        u_out, v_out = torch.empty_like(i1), torch.empty_like(i1)
        gsu = gsv = None
        cy = cx = None
        gh = gw = 0
    else:
        if grid_plan.cell_y.shape != (h,) or grid_plan.cell_x.shape != (w,):
            raise ValueError("flow_refine: grid plan is for another level size")
        gh, gw = grid_plan.gh, grid_plan.gw
        gsu = torch.zeros((bsz, gh, gw), dtype=torch.float32, device=i1.device)
        gsv = torch.zeros_like(gsu)
        cy, cx = grid_plan.cell_y, grid_plan.cell_x
        u_out = v_out = None

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = build.library()
    with build.on_device(i1.device):
        status = lib.ofps_flow_refine(
            ptr(i1), ptr(i2), ptr(u), ptr(v), ptr(yi), ptr(yw), ptr(xi), ptr(xw),
            scale, ptr(u_out), ptr(v_out), ptr(cy), ptr(cx), ptr(gsu), ptr(gsv),
            gh, gw, bsz, h, w, hc, wc, win, int(cost_dtype == torch.bfloat16),
            int(median_in), build.stream_ptr(i1.device),
        )
    build.check(status, "ofps_flow_refine")
    flow_refine.launches += 1
    flow_refine.median_in_launches += int(median_in)
    if grid_plan is not None:
        return gsu, gsv
    return u_out, v_out


flow_refine.launches = 0
flow_refine.median_in_launches = 0  # launches that took the fused median
