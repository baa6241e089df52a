"""The least time the H100 could take for the frames step's hand kernels.

A copy of ``chip_smoke.py``'s cost arithmetic (the lines cited below), so
that the yardstick stays put when the program changes.  Bytes count each
input read once and each output written once; operations count the float32
operations the function needs per pixel, not what a kernel repeats.  The
peaks are the published ones of one H100 SXM at 700 W, dense.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# chip_smoke.py:350-351
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# chip_smoke.py:357-359: a bilinear sample; one |diff|; one upsampled plane.
WARP_OPS = 23
DIFF_OPS = 3
UPSAMPLE_OPS = 10
# chip_smoke.py:368: a 3x3 median of both flow planes, 19 exchanges each.
MEDIAN_OPS = 2 * 19 * 2


def box_ops(win: int) -> int:
    """chip_smoke.py:362-363: a separable win x win box sum, per pixel."""
    return 2 * (win - 1)


def sweep_cost(batch, h, w, hc, wc, n_cand, win, out_bytes=None) -> Tuple[int, int]:
    """chip_smoke.py:475-485: (bytes, ops) of one refine launch at a (h, w)
    level from a (hc, wc) flow."""
    px = batch * h * w
    nbytes = 4 * (2 * px + 2 * batch * hc * wc) + (8 * px if out_bytes is None else out_bytes)
    per_px = (WARP_OPS + n_cand * (DIFF_OPS + box_ops(win) + 2) + n_cand + 2 * 8 + 2
              + (2 * UPSAMPLE_OPS if (hc, wc) != (h, w) else 0))
    return nbytes, px * per_px


def guard_cost(batch, h, w, win) -> Tuple[int, int]:
    """chip_smoke.py:549-556: 6 planes in, 2 out; per pixel and flow the
    warp, |diff|, box sum and divide, then the compare and two selects."""
    px = batch * h * w
    return 4 * 8 * px, px * (2 * (WARP_OPS + 2 + box_ops(win) + 1) + 3)


def level_shapes(h: int, w: int, levels: int) -> List[Tuple[int, int]]:
    """(h, w) of each pyramid level, finest first (2x2 pooling truncates)."""
    out = [(h, w)]
    for _ in range(levels - 1):
        h, w = h // 2, w // 2
        out.append((h, w))
    return out


def serving_launches(batch: int, h: int, w: int, grid_hw: Tuple[int, int], levels: int = 6,
                     win: int = 5) -> Dict[str, List[Tuple[int, int]]]:
    """(bytes, ops) of each launch of one frames step, by kernel: levels 0
    to 3 by ``refine_sep_kernel`` (level 0 writes the grid sums, levels 1 to
    3 take the 3x3 median of the coarser flow), level 4 by one
    ``refine_2d_kernel`` sweep of radius 1 (with the median), the coarsest
    level by two radius-6 sweeps (warm and zero start) and one
    ``guard_kernel`` (chip_smoke.py:560-640, the serving cases)."""
    shapes = level_shapes(h, w, levels)
    gh, gw = grid_hw
    out = {"refine_sep_kernel": [], "refine_2d_kernel": [], "guard_kernel": []}
    for lvl in range(levels - 1):
        hh, ww = shapes[lvl]
        hc, wc = shapes[lvl + 1]
        median = lvl + 1 >= 2
        if lvl <= 3:
            grid = 8 * batch * gh * gw if lvl == 0 else None
            nb, ops = sweep_cost(batch, hh, ww, hc, wc, 5, win, grid)
            key = "refine_sep_kernel"
        else:
            nb, ops = sweep_cost(batch, hh, ww, hc, wc, 9, win)
            key = "refine_2d_kernel"
        if median:
            ops += MEDIAN_OPS * batch * hc * wc
        out[key].append((nb, ops))
    hh, ww = shapes[-1]
    for _ in range(2):
        out["refine_2d_kernel"].append(sweep_cost(batch, hh, ww, hh, ww, 13 * 13, win))
    out["guard_kernel"].append(guard_cost(batch, hh, ww, win))
    return out


def bound_ms(cost: Tuple[int, int]) -> float:
    """The larger of bytes over peak bytes/s and operations over peak
    float32 operations/s, in ms."""
    return 1e3 * max(cost[0] / HBM_BYTES_PER_S, cost[1] / FP32_OPS_PER_S)


def step_bound_ms(batch: int, h: int, w: int, grid_hw: Tuple[int, int]) -> float:
    """The least time for one frames step's hand kernels, in ms."""
    return sum(bound_ms(c) for cs in serving_launches(batch, h, w, grid_hw).values() for c in cs)
