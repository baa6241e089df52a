# Frozen copy of the port's plain ``ofps_torch/ops/flow_pyramid.py`` (the benchmark's
# reference; it imports nothing of the port).
"""Dense optical flow: coarse-to-fine pyramid block matching (port of
``ofps_tpu.ops.flow_pyramid``).

The plain versions of the port's flow kernels and pyramid (with the plain
halves of ``kernels/flow_refine.py`` and ``kernels/flow_refine_small.py``):
exact warp, ``_level_refine``, ``_coarse_guard``, bilinear flow upsample,
3x3 median, and the grid sums of the finest level as one-hot products.

Flow travels as split ``(u, v)`` planes of shape ``(B, H, W)`` in float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ofps_bench.reference.image import (
    box_filter, build_pyramid, median3x3, resize_bilinear, warp_bilinear,
)
from ofps_bench.reference.motion import grid_scatter_plan_np

_BIG = 1e10
# Per-pixel-of-shift displacement prior, in box-mean cost units.
_TIE_EPS = np.float32(1e-3)


class FlowParams(NamedTuple):
    levels: int = 6
    search: int = 1  # mid-level search radius
    win: int = 5  # aggregation window
    coarse_search: int = 6  # wider search at the coarsest level
    min_level_size: int = 16  # clamp pyramid depth so levels stay meaningful
    fine_search: int = 1  # radius at the finest level
    # |diff| operand dtype: bfloat16 rounds each |diff| before the float32
    # box sum (as the JAX package does); float32 keeps it exact.
    cost_dtype: torch.dtype = torch.bfloat16
    # Smallest level (pixels) refined by the axis-separable kernel
    # (kernels.flow_refine); smaller levels take the full 2-D sweep
    # (kernels.flow_refine_small).
    fuse_min_pixels: int = 30_000
    # 5-cost axis-separable refine on search=1 levels of >= fuse_min_pixels.
    axis_sep: bool = True
    # Edge band replicated from the interior; None = auto, 0 disables.
    border_margin: Optional[int] = None
    median_levels: bool = True  # 3x3 median after every level >= 2
    guarded_warm: bool = True  # warm/zero-init race at the coarsest level


def auto_margin(params: FlowParams, levels: int, h: int, w: int) -> int:
    """Edge-band width to replicate over: the coarse level's matching
    footprint (half window + 1) upsampled to full resolution, capped at an
    eighth of the frame."""
    if params.border_margin is not None:
        m = params.border_margin
    else:
        m = (params.win // 2 + 1) * 2 ** max(levels - 2, 0)
    return max(0, min(m, (h - 1) // 8, (w - 1) // 8))


def border_margin_px(params: FlowParams, h: int, w: int) -> int:
    """The invalid edge-band width (px) of a (h, w) flow."""
    return auto_margin(params, effective_levels(params, h, w), h, w)


def _replicate_border_uv(u, v, m: int):
    """Overwrite the outer ``m``-pixel band with the nearest interior value."""
    if m <= 0:
        return u, v

    def fix(x):
        h, w = x.shape[-2], x.shape[-1]
        yi = torch.clamp(torch.arange(h, device=x.device), m, h - 1 - m)
        xi = torch.clamp(torch.arange(w, device=x.device), m, w - 1 - m)
        return x.index_select(-2, yi).index_select(-1, xi)

    return fix(u), fix(v)


def effective_levels(params: FlowParams, h: int, w: int) -> int:
    levels = 1
    size = min(h, w)
    while levels < params.levels and size // 2 >= params.min_level_size:
        size //= 2
        levels += 1
    return levels


def level_search(params: FlowParams, lvl: int, levels: int) -> int:
    if lvl == levels - 1:
        return params.coarse_search
    if lvl == 0 and levels > 1:
        return params.fine_search
    return params.search


def uses_axis_sep(params: FlowParams, search: int, h: int, w: int) -> bool:
    """Whether a level runs the axis-separable refine (kernels.flow_refine)."""
    return params.axis_sep and search == 1 and h * w >= params.fuse_min_pixels


def grid_fusable(params: FlowParams, h: int, w: int) -> bool:
    """Whether the finest level can emit grid-densify sums in place of
    full-resolution flow (it must be an axis-separable level)."""
    levels = effective_levels(params, h, w)
    return levels > 1 and uses_axis_sep(
        params, level_search(params, 0, levels), h, w
    )


class FrameCache(NamedTuple):
    """A frame's float32 pyramid, finest first (``pyr[0]`` IS the frame),
    carried so it is built once per frame in a stream."""

    pyr: Tuple[torch.Tensor, ...]


def frame_cache(img: torch.Tensor, params: FlowParams = FlowParams()) -> FrameCache:
    h, w = img.shape[-2], img.shape[-1]
    return FrameCache(pyr=tuple(build_pyramid(img, effective_levels(params, h, w))))


def _shifted_edge(x: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """out[..., y, x] = x[..., clamp(y + dy), clamp(x + dx)] (edge pad)."""
    h, w = x.shape[-2], x.shape[-1]
    yi = torch.clamp(torch.arange(h, device=x.device) + dy, 0, h - 1)
    xi = torch.clamp(torch.arange(w, device=x.device) + dx, 0, w - 1)
    return x.index_select(-2, yi).index_select(-1, xi)


def _parabola(cm, cc, cp):
    denom = cm - 2.0 * cc + cp
    big = torch.abs(denom) > 1e-12
    off = 0.5 * (cm - cp) / torch.clamp(torch.abs(denom), min=1e-12) * torch.sign(denom)
    off = torch.where(big, off, torch.zeros_like(off))
    return torch.clamp(off, -0.5, 0.5)


def _level_refine(
    i1, warped, search: int, win: int, cost_dtype=torch.bfloat16,
    axis_sep: bool = False,
):
    """Residual displacement ``(du, dv)`` for one level: SAD cost sweep over
    the (2s+1)^2 integer candidates, argmin, per-axis parabola subpixel.

    The plain version of both refine kernels.  Candidate windows are
    edge-padded, the box sum zero-pads the |diff| taps outside the image
    (and still divides by win^2), an out-of-image centre REPLACES the cost
    with 1e10, and a 1e-3/px prior breaks plateaus toward small shifts.
    The 2-D mode takes the first minimum in dy-outer order (strict <);
    ``axis_sep`` (search 1 only) refines each axis from the 5-cost cross.
    """
    h, w = i1.shape[-2], i1.shape[-1]
    dev = i1.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]

    def cand_cost(dx, dy):
        diff = torch.abs(i1 - _shifted_edge(warped, dx, dy))
        c = box_filter(diff.to(cost_dtype).to(torch.float32), win)
        oob = (xs + dx < 0) | (xs + dx > w - 1) | (ys + dy < 0) | (ys + dy > h - 1)
        tie = float(_TIE_EPS * np.float32(abs(dx) + abs(dy)))
        return torch.where(oob, torch.full_like(c, _BIG), c + tie)

    if axis_sep:
        if search != 1:
            raise ValueError("axis_sep is a search=1 mode")
        cym, cxm, c00, cxp, cyp = (
            cand_cost(dx, dy) for dx, dy in ((0, -1), (-1, 0), (0, 0), (1, 0), (0, 1))
        )

        def axis_refine(cm, cc, cp):
            one = torch.ones_like(cc)
            bi = torch.where(
                cm < cc,
                torch.where(cm <= cp, -one, one),
                torch.where(cp < cc, one, torch.zeros_like(cc)),
            )
            return bi + torch.where(bi == 0, _parabola(cm, cc, cp), torch.zeros_like(cc))

        return axis_refine(cxm, c00, cxp), axis_refine(cym, c00, cyp)

    side = 2 * search + 1
    costs = torch.stack(
        [
            cand_cost(s % side - search, s // side - search)
            for s in range(side * side)
        ]
    )
    best_s = torch.argmin(costs, dim=0)  # first minimum == strict-< scan
    bx = best_s % side - search
    by = torch.div(best_s, side, rounding_mode="floor") - search

    def pick(idx):
        return torch.gather(costs, 0, idx[None]).squeeze(0)

    c0 = pick(best_s)
    cxm = pick(best_s - (bx > -search).long())
    cxp = pick(best_s + (bx < search).long())
    cym = pick(best_s - side * (by > -search).long())
    cyp = pick(best_s + side * (by < search).long())
    zero = torch.zeros_like(c0)
    sub_x = torch.where(bx.abs() == search, zero, _parabola(cxm, c0, cxp))
    sub_y = torch.where(by.abs() == search, zero, _parabola(cym, c0, cyp))
    return bx.to(torch.float32) + sub_x, by.to(torch.float32) + sub_y


def _coarse_guard(a, b, u_w, v_w, u_0, v_0, win: int):
    """Per-pixel winner of the warm and zero-init solutions by the box-mean
    SAD of the warp at each REFINED flow; ties keep the warm solution."""

    def sad(uu, vv):
        return box_filter(torch.abs(a - warp_bilinear(b, uu, vv)), win)

    better = sad(u_w, v_w) <= sad(u_0, v_0)
    return torch.where(better, u_w, u_0), torch.where(better, v_w, v_0)


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


def flow_refine_small_plain(i1, i2, u, v, search: int, win: int,
                            cost_dtype=torch.bfloat16, median_in: bool = False):
    """Plain PyTorch version of :func:`flow_refine_small`, on any device."""
    if median_in:
        u, v = median3x3_uv_plain(u, v)
    h, w = i1.shape[-2], i1.shape[-1]
    if u.shape[-2:] != (h, w):
        u = resize_bilinear(u, h, w) * 2.0
        v = resize_bilinear(v, h, w) * 2.0
    du, dv = _level_refine(i1, warp_bilinear(i2, u, v), search, win, cost_dtype)
    return u + du, v + dv


def guard_select_plain(a, b, u_w, v_w, u_0, v_0, win: int):
    """Plain PyTorch version of :func:`guard_select`, on any device."""
    return _coarse_guard(a, b, u_w, v_w, u_0, v_0, win)


def median3x3_uv_plain(u, v):
    """3x3 median (edge clamp) of both flow planes: what ``median_in``
    applies to the coarser flow, on any device."""
    return median3x3(u), median3x3(v)


class _Ops(NamedTuple):
    refine_sep: object
    refine_2d: object
    guard: object


_PLAIN_OPS = _Ops(flow_refine_plain, flow_refine_small_plain, guard_select_plain)


def _dense_flow_impl(
    i1: torch.Tensor,
    i2: torch.Tensor,
    params: FlowParams,
    init_uv=None,
    prev_cache: Optional[FrameCache] = None,
    grid_plan=None,
    plain: bool = False,
    frame_shape: Optional[Tuple[int, int]] = None,
):
    """Pyramid loop: returns ``(u, v, warm, cache)``, with ``warm`` the
    level-1 flow and ``cache`` the :class:`FrameCache` of ``i2``.

    ``frame_shape``: the (H, W) of the whole frame when ``i1``/``i2`` are
    a column band of it (:mod:`ofps_torch.parallel.spatial`): the depth
    and each level's refine are chosen from the frame's level sizes, so a
    band runs the unsharded pyramid's algorithm.

    ``init_uv``: optional (u, v) warm start at any resolution, resized to
    the coarsest level (jax's antialiased bilinear resize) and clamped to
    ``coarse_search - 1``.  ``grid_plan`` (:func:`kernels.flow_refine.
    build_grid_plan`): the finest level emits the plan's (gh, gw) grid
    sums instead of full-resolution flow; requires :func:`grid_fusable`.

    The 3x3 median after each level >= 2 (``params.median_levels``) runs
    in the next level's refine (``median_in``), whose upsample is its only
    reader; ``warm`` (level 1) is never filtered.
    """
    ops = _PLAIN_OPS
    h0, w0 = i1.shape[-2], i1.shape[-1]
    levels = effective_levels(params, *(frame_shape or (h0, w0)))
    pyr1 = list(prev_cache.pyr) if prev_cache is not None else build_pyramid(i1, levels)
    if len(pyr1) != levels:
        raise ValueError(f"prev_cache has {len(pyr1)} levels, expected {levels}")
    pyr2 = build_pyramid(i2, levels)
    if grid_plan is not None and not grid_fusable(params, h0, w0):
        raise ValueError("grid_plan needs an axis-separable finest level")

    u = v = None
    if init_uv is not None:
        u0, v0 = init_uv
        h, w = pyr1[-1].shape[-2], pyr1[-1].shape[-1]
        scale = h / u0.shape[-2]
        clamp = float(params.coarse_search - 1)
        u = torch.clamp(resize_bilinear(u0.float(), h, w) * scale, -clamp, clamp)
        v = torch.clamp(resize_bilinear(v0.float(), h, w) * scale, -clamp, clamp)

    warm_out = None
    median_pending = False
    for lvl in range(levels - 1, -1, -1):
        a, b = pyr1[lvl], pyr2[lvl]
        h, w = a.shape[-2], a.shape[-1]
        search = level_search(params, lvl, levels)
        # The size that picks the refine: the frame's at this level.
        fh, fw = (h, w) if frame_shape is None else (frame_shape[0] >> lvl, frame_shape[1] >> lvl)
        if u is None:
            u = torch.zeros_like(a)
            v = torch.zeros_like(a)
        if lvl == levels - 1 and init_uv is not None and params.guarded_warm:
            u_w, v_w = ops.refine_2d(a, b, u, v, search, params.win, params.cost_dtype)
            zero = torch.zeros_like(a)
            u_0, v_0 = ops.refine_2d(a, b, zero, zero, search, params.win, params.cost_dtype)
            u, v = ops.guard(a, b, u_w, v_w, u_0, v_0, params.win)
        elif uses_axis_sep(params, search, fh, fw):
            plan = grid_plan if lvl == 0 else None
            u, v = ops.refine_sep(
                a, b, u, v, params.win, params.cost_dtype, grid_plan=plan,
                median_in=median_pending,
            )
        else:
            u, v = ops.refine_2d(
                a, b, u, v, search, params.win, params.cost_dtype, median_in=median_pending
            )
        median_pending = params.median_levels and lvl >= 2
        if lvl == 1 or levels == 1:
            warm_out = (u, v)
    return u, v, warm_out, FrameCache(pyr=tuple(pyr2))


def dense_flow(
    i1: torch.Tensor,
    i2: torch.Tensor,
    params: FlowParams = FlowParams(),
    init_flow: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> torch.Tensor:
    """Dense flow i1 -> i2 in pixels, packed (..., H, W, 2), with the
    invalid edge band replicated from the interior."""
    init_uv = None
    if init_flow is not None:
        init_uv = (init_flow[..., 0], init_flow[..., 1])
    u, v, _, _ = _dense_flow_impl(i1, i2, params, init_uv, plain=plain)
    u, v = _replicate_border_uv(u, v, border_margin_px(params, *u.shape[-2:]))
    return torch.stack([u, v], dim=-1)


def dense_flow_warm(
    i1: torch.Tensor,
    i2: torch.Tensor,
    params: FlowParams = FlowParams(),
    warm=None,
    prev_cache: Optional[FrameCache] = None,
    grid_plan=None,
    plain: bool = False,
    frame_shape: Optional[Tuple[int, int]] = None,
):
    """Streaming dense flow: returns ``((u, v), warm_next, cache)``.

    ``(u, v)`` is the full-resolution flow, or the (gh, gw) grid sums when
    ``grid_plan`` is given; ``warm_next`` is the refined half-resolution
    flow to pass as ``warm`` on the next frame; ``cache`` is ``i2``'s
    :class:`FrameCache`, to pass as ``prev_cache`` with the next frame.
    ``frame_shape``: see :func:`_dense_flow_impl` (column bands).
    """
    u, v, warm_next, cache = _dense_flow_impl(
        i1, i2, params, warm, prev_cache, grid_plan=grid_plan, plain=plain,
        frame_shape=frame_shape,
    )
    return (u, v), warm_next, cache
