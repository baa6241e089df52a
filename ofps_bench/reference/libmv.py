# Frozen copy of the port's plain ``ofps_torch/estimators/libmv.py`` (the benchmark's
# reference; it imports nothing of the port).
"""Fundamental-matrix camera-motion estimator, "libmv" (port of
``ofps_tpu.estimators.libmv``).

A robust 7- or 8-point fundamental matrix, the essential matrix Kᵀ F K,
(R, t) by the cheirality of one correspondence, and a translation-scale
chain: the flows are chained across three views through a spatial index
of the previous frame's endpoints (a 40x40 raster grid, nearest entry
within +-0.05 in a 5x5 neighbourhood), a second fundamental solve on the
chained field gives the 1 -> 3 translation direction, and
``triangulate_scale`` keeps the translation magnitude consistent along the
chain.  The only estimator with a nonzero translation, and the only one
that carries state (:class:`PrevMotion`) from frame to frame.

The state is batched over B streams, and the whole step is a fixed
sequence of device operations, so the stream pipeline replays it, state
and all, inside its CUDA graph.  The chained field's mask depends on the
data, so its RANSAC draws come in as uniforms and are mapped to valid
points on the device (``ops.robust.indices_from_uniform``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ofps_bench.reference import quat
from ofps_bench.reference.motion import SparseFlow
from ofps_bench.reference.est_base import EstimatorInstance, camera_intrinsics, register
from ofps_bench.reference.convention import remap_solver_rotation
from ofps_bench.reference.epipolar import (
    eight_point_fundamental,
    essential_from_fundamental,
    homogeneous,
    motion_from_essential_and_correspondence,
    refine_pose_sampson,
    rotation_only_fallback,
    sampson_error,
    seven_point_fundamental,
    transform_points,
)
from ofps_bench.reference.robust import (
    draw,
    draw_dense,
    indices_from_uniform,
    ransac_budget,
    robust_fit,
    sample_indices,
)
from ofps_bench.reference.solve import solve3x3

GRID = 40  # spatial-index resolution; cell size 0.025 covers the 0.05 range
_RANGE = 0.05  # nearest-entry search box


class LibmvParams(NamedTuple):
    outlier_proba: float = 0.7
    max_error: float = 0.0001
    algo_points: int = 7
    num_hypotheses: int = 512
    desired_confidence: float = 0.999
    eval_cap: int = 2048
    prescore_cap: int = 128
    finalists: int = 32
    adaptive_threshold: bool = True
    refit_weight: str = "binary"
    lo_iters: int = 2
    gn_polish: bool = True
    gn_iters: int = 3
    # The Kabsch rotation-only fallback, on the primary solve only.
    rotation_fallback: bool = True


def hypothesis_count(params: LibmvParams) -> int:
    """RANSAC batch size: 512 at the defaults (1,536 7-point candidates)."""
    return ransac_budget(params.desired_confidence, params.outlier_proba,
                         params.algo_points, params.num_hypotheses)


class PrevMotion(NamedTuple):
    """Spatial index of the previous chained flow, keyed by endpoint cell;
    every field has the leading stream dims of the batch."""

    pos: torch.Tensor  # (..., G, G, 2) start position of the stored entry
    motion: torch.Tensor  # (..., G, G, 2)
    valid: torch.Tensor  # (..., G, G) float 0/1
    rot: torch.Tensor  # (..., 4) accumulated rotation since the chain started
    tr: torch.Tensor  # (..., 3) scaled translation when the chain started
    has: torch.Tensor  # (...) float 0/1: a chain exists

    @classmethod
    def empty(cls, device="cpu") -> "PrevMotion":
        return cls(
            pos=torch.zeros((GRID, GRID, 2), device=device),
            motion=torch.zeros((GRID, GRID, 2), device=device),
            valid=torch.zeros((GRID, GRID), device=device),
            rot=quat.identity(device=device),
            tr=torch.zeros(3, device=device),
            has=torch.zeros((), device=device),
        )


def _cell(p: torch.Tensor) -> torch.Tensor:
    """Raster cell (..., N) of positions (..., N, 2), clamped to the grid."""
    cx = torch.clamp((p[..., 0] * GRID).to(torch.int64), 0, GRID - 1)
    cy = torch.clamp((p[..., 1] * GRID).to(torch.int64), 0, GRID - 1)
    return cy * GRID + cx


def rasterize_prev(pos: torch.Tensor, motion: torch.Tensor, w: torch.Tensor):
    """Entries (..., N) keyed by their endpoint cell into (..., G, G, 2)
    positions and motions and (..., G, G) validity.

    The JAX package's duplicate rules, with the winner picked explicitly
    (a scatter with duplicate indices is not deterministic on CUDA): every
    cell but 0 keeps the last entry in raster order; invalid entries are
    dumped on cell 0, which is then rebuilt from the first valid entry that
    maps there."""
    n = w.shape[-1]
    valid = w > 0.5
    idx = torch.where(valid, _cell(pos + motion), 0)
    ent = torch.arange(n, device=w.device).expand(idx.shape)
    lead = idx.shape[:-1]
    last = torch.full(lead + (GRID * GRID,), -1, dtype=torch.int64, device=w.device)
    last = last.scatter_reduce(-1, idx, ent, "amax")
    first0 = torch.where(valid & (idx == 0), ent, n).amin(-1, keepdim=True)
    win = torch.cat([torch.where(first0 < n, first0, -1), last[..., 1:]], dim=-1)
    src = torch.clamp(win, min=0)[..., None].expand(lead + (GRID * GRID, 2))
    keep = (win >= 0)[..., None]
    gp = torch.where(keep, torch.gather(pos, -2, src), 0.0)
    gm = torch.where(keep, torch.gather(motion, -2, src), 0.0)
    gv = torch.zeros(lead + (GRID * GRID,), dtype=w.dtype, device=w.device)
    gv = gv.scatter_reduce(-1, idx, w, "amax")
    gv = torch.cat([(first0 < n).to(w.dtype), gv[..., 1:]], dim=-1)
    grid = lead + (GRID, GRID)
    return gp.reshape(grid + (2,)), gm.reshape(grid + (2,)), gv.reshape(grid)


@functools.lru_cache(maxsize=8)
def _neighbour_cells(device: str) -> torch.Tensor:
    """(G*G, 25): the edge-clamped cells of each cell's 5x5 neighbourhood,
    dy-major, dx-minor."""
    y, x = np.divmod(np.arange(GRID * GRID), GRID)
    d = np.arange(-2, 3)
    ny = np.clip(y[:, None, None] + d[None, :, None], 0, GRID - 1)
    nx = np.clip(x[:, None, None] + d[None, None, :], 0, GRID - 1)
    return torch.from_numpy((ny * GRID + nx).reshape(GRID * GRID, 25)).to(device)


def find_nearest(prev: PrevMotion, query: torch.Tensor, w: torch.Tensor):
    """The stored entry whose endpoint is nearest (L1) to each query start
    position (..., N, 2) within the +-0.05 box: (pos, motion, found), the
    first of equal distances in dy-major, dx-minor order; rows not found
    are zero."""
    lead, n = query.shape[:-2], query.shape[-2]
    rec = torch.cat([prev.pos, prev.motion, prev.valid[..., None]], dim=-1)
    rec = rec.reshape(lead + (GRID * GRID, 5))
    cells = _neighbour_cells(str(query.device))[_cell(query)]  # (..., N, 25)
    cand = torch.gather(rec, -2, cells.reshape(lead + (n * 25, 1)).expand(lead + (n * 25, 5)))
    cand = cand.reshape(lead + (n, 25, 5))
    d = torch.abs(query[..., None, :] - (cand[..., 0:2] + cand[..., 2:4]))
    inbox = (d[..., 0] < _RANGE) & (d[..., 1] < _RANGE) & (cand[..., 4] > 0.5)
    l1 = torch.where(inbox, d[..., 0] + d[..., 1], 1e9)
    am = torch.argmin(l1, dim=-1)  # first minimum: the scan's strict-< winner
    found = inbox.any(-1)
    sel = torch.gather(cand, -2, am[..., None, None].expand(lead + (n, 1, 5)))[..., 0, :]
    fz = found[..., None].to(sel.dtype)
    return sel[..., 0:2] * fz, sel[..., 2:4] * fz, found & (w > 0.5)


def triangulate_scale(ab: torch.Tensor, bc: torch.Tensor, ac: torch.Tensor) -> torch.Tensor:
    """Scale factor (...) for bc consistent with ab: x[0] of [-bc, ac, bc x
    ac] x = ab, or 1 where that system is singular (parallel lines)."""
    lhs = torch.stack([-bc, ac, torch.linalg.cross(bc, ac, dim=-1)], dim=-1)
    x = solve3x3(lhs, ab, fallback=float("nan"))
    return torch.where(torch.isnan(x[..., 0]), 1.0, x[..., 0])


def _remap_vec(v: torch.Tensor) -> torch.Tensor:
    """Translation solver -> codebase axis remap: (x, y, z) -> (x, z, -y)."""
    return torch.stack([v[..., 0], v[..., 2], -v[..., 1]], dim=-1)


def _minimal_eight(x1s, x2s, ws):
    f = eight_point_fundamental(x1s, x2s, ws)
    return f[..., None, :, :], torch.ones(f.shape[:-2] + (1,), dtype=torch.bool, device=f.device)


def _pose_from_field(params: LibmvParams, camera, pos, motion, w, idx, max_error,
                     dense: bool, rot_fallback: bool):
    """Fundamental -> essential -> (R, t) of a (possibly chained) field,
    with the RANSAC draws ``idx`` (..., H, k)."""
    x1 = pos
    x2 = pos + motion
    res = robust_fit(
        x1, x2, w,
        minimal_fit=seven_point_fundamental if params.algo_points == 7 else _minimal_eight,
        sample_size=params.algo_points,
        error_fn=sampson_error,
        num_hypotheses=hypothesis_count(params),
        threshold=params.max_error if max_error is None else max_error,
        use_lmeds=False,
        eval_cap=params.eval_cap,
        adaptive_threshold=params.adaptive_threshold,
        prescore_cap=params.prescore_cap,
        finalists=params.finalists,
        refit_fn=eight_point_fundamental,
        refit_weight=params.refit_weight,
        lo_iters=params.lo_iters,
        dense=dense,
        idx=idx,
    )
    k, kinv = camera_intrinsics(camera, str(pos.device))
    e = essential_from_fundamental(res.model, k)
    # The cheirality of the first inlier.
    first = torch.argmax(res.inliers, dim=-1)[..., None, None].expand(w.shape[:-1] + (1, 2))
    r, t, _ = motion_from_essential_and_correspondence(
        e, k, torch.gather(x1, -2, first)[..., 0, :], torch.gather(x2, -2, first)[..., 0, :])
    if params.gn_polish or rot_fallback:
        x1n = transform_points(homogeneous(x1), kinv)
        x2n = transform_points(homogeneous(x2), kinv)
        x1n = x1n[..., :2] / x1n[..., 2:]
        x2n = x2n[..., :2] / x2n[..., 2:]
    if params.gn_polish:
        r, t = refine_pose_sampson(r, t, x1n, x2n, res.inliers * w, iters=params.gn_iters)
    if rot_fallback:
        r, _ = rotation_only_fallback(r, x1n, x2n, res.inliers * w)
    return r, t


def _where(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``where`` with the condition (...) broadcast over a's trailing dims."""
    return torch.where(c.reshape(c.shape + (1,) * (a.dim() - c.dim())), a, b)


def estimate_libmv(params: LibmvParams, state: PrevMotion, flow: SparseFlow, camera,
                   draws, move_magnitude=None, max_error=None, dense: bool = False):
    """One step: (rotation (..., 4), translation (..., 3), new state).
    ``draws``: (the primary solve's draws (..., H, k), indices or uniforms
    over the valid points; the chained field's uniforms (..., H, k)).
    ``move_magnitude``, where given, replaces the chained translation
    magnitude in the output and in the chain anchor."""
    idx1, u2 = draws
    pos, motion, w = flow.pos, flow.motion, flow.mask
    r_mat, t_raw = _pose_from_field(params, camera, pos, motion, w, idx1, max_error,
                                    dense, params.rotation_fallback)
    q = remap_solver_rotation(quat.from_matrix3(r_mat))
    tm = torch.sqrt(torch.sum(t_raw * t_raw, dim=-1, keepdim=True))
    has_t = tm > 1e-6  # (..., 1)
    t_world = _remap_vec(t_raw)
    t_unit = torch.where(has_t, t_world / torch.clamp(tm, min=1e-20), t_world)

    # Translation-scale chain: the current flows through the previous
    # endpoint index, then a solve on the chained (view 1 -> 3) field.
    ne_pos, ne_mot, found = find_nearest(state, pos, w)
    new_grid = rasterize_prev(ne_pos, ne_mot + motion, found.to(torch.float32))
    chained_rot = quat.mul(q, state.rot)
    lead = w.shape[:-1]
    cp = new_grid[0].reshape(lead + (-1, 2))
    cm = new_grid[1].reshape(lead + (-1, 2))
    cw = new_grid[2].reshape(lead + (-1,))
    _, t13_raw = _pose_from_field(params, camera, cp, cm, cw, indices_from_uniform(u2, cw),
                                  max_error, False, False)
    t13 = _remap_vec(t13_raw)
    t23 = quat.rotate_vec(chained_rot, t_unit)
    scale = triangulate_scale(state.tr, t23, t13)[..., None]

    had_prev = (state.has > 0.5)[..., None]
    use_chain = had_prev & has_t
    one, zero = torch.ones_like(scale), torch.zeros_like(scale)
    sf = torch.where(had_prev, torch.where(has_t, scale, zero), torch.where(has_t, one, zero))
    # A completed (or started) chain step resets the index to the current
    # field; with no translation on an existing chain, the chain persists.
    cur_grid = rasterize_prev(pos, motion, w)
    reset_tr = t_unit * torch.where(use_chain, scale, one)
    if move_magnitude is not None:
        mm = torch.as_tensor(move_magnitude, dtype=torch.float32, device=w.device)
        mm = mm.reshape(mm.shape + (1,)).expand(scale.shape)
        sf = torch.where(has_t, mm, zero)
        reset_tr = t_unit * torch.where(has_t, mm, one)
    reset = (use_chain | ~had_prev)[..., 0]
    new_state = PrevMotion(
        pos=_where(reset, cur_grid[0], new_grid[0]),
        motion=_where(reset, cur_grid[1], new_grid[1]),
        valid=_where(reset, cur_grid[2], new_grid[2]),
        rot=_where(reset, q, chained_rot),
        tr=_where(reset, reset_tr, state.tr),
        has=torch.maximum(state.has, has_t[..., 0].to(torch.float32)),
    )
    return q, t_unit * sf, new_state


@register("libmv")
def make_libmv(**kwargs) -> EstimatorInstance:
    params = LibmvParams(**kwargs)
    h_count, k = hypothesis_count(params), params.algo_points

    def draw_both(generator, lead, n, device, dense=True):
        """(the primary solve's draws (*lead, H, k): dense indices, or
        uniforms for a masked flow; the chained field's uniforms (*lead, H,
        k))."""
        primary = draw(generator, lead, n, h_count, k, device, dense)
        return primary, torch.rand(tuple(lead) + (h_count, k), generator=generator, device=device)

    def estimate(state: PrevMotion, flow: SparseFlow, camera, generator=None, props=None,
                 dense=False, fit_idx=None, move_magnitude=None, plain=False):
        # ``plain`` is accepted and unused: no hand kernel to stand in for.
        if fit_idx is None:
            w = flow.mask
            idx = (draw_dense(generator, w.shape[:-1], w.shape[-1], h_count, k, w.device)
                   if dense else sample_indices(generator, w.shape[-1], h_count, k, w=w))
            fit_idx = idx, torch.rand(idx.shape, generator=generator, device=w.device)
        rot, tr, new_state = estimate_libmv(
            params, state, flow, camera, fit_idx, move_magnitude=move_magnitude,
            max_error=(props or {}).get("max_error"), dense=dense,
        )
        # Degenerate input: hold the pose and the state.
        ok = ((torch.sum(flow.mask, dim=-1) >= params.algo_points)
              & torch.isfinite(rot).all(-1) & torch.isfinite(tr).all(-1))
        rot = torch.where(ok[..., None], rot, quat.identity(device=rot.device))
        tr = torch.where(ok[..., None], tr, 0.0)
        new_state = PrevMotion(*(_where(ok, a, b) for a, b in zip(new_state, state)))
        return rot, tr, new_state

    return EstimatorInstance(
        name="libmv",
        params=params,
        init=PrevMotion.empty,
        estimate=estimate,
        dyn_defaults=lambda: {"max_error": float(params.max_error)},
        draw=draw_both,
    )
