# Frozen copy of the port's plain ``ofps_torch/estimators/almeida.py`` (the benchmark's
# reference; it imports nothing of the port).
"""Almeida camera-rotation estimator: iterative least squares + RANSAC
(port of ``ofps_tpu.estimators.almeida``).

All hypotheses of a batch of streams are fitted and scored at once on
``(B, 3, H)`` / ``(B, H, S)`` planes, then the winning inlier set is refit.
``dense=True`` (the serving configuration's all-valid densified grid) takes
static draws and a static eval subset (``ops.robust.dense_eval_indices``);
``dense=False`` draws valid points with the masked sampler and compacts the
eval subset from the mask at run time (``ops.robust.eval_subset``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ofps_bench.reference import quat
from ofps_bench.reference.motion import SparseFlow
from ofps_bench.reference.est_base import EstimatorInstance, register
from ofps_bench.reference.geometry_uv import (
    delta_planes,
    point_angle_planes,
    qconj,
    qident_like,
    qmat,
    qmul,
    solve3_planes,
)
from ofps_bench.reference.robust import (
    as_indices,
    dense_eval_subset,
    draw,
    draw_dense,
    eval_subset,
    sample_indices,
)

EPS = 0.001 * math.pi / 180.0
ALPHA = 0.5
_LSQ_ITERS = math.ceil(15.0 / ALPHA)  # 30


class AlmeidaParams(NamedTuple):
    use_ransac: bool = True
    num_iters: int = 200
    inlier_angle_deg: float = 0.05
    ransac_samples: int = 1000


@functools.lru_cache(maxsize=None)
def _proto_mats():
    """The three constant EPS-rotation matrices as 9-tuples of floats."""
    return tuple(
        tuple(quat.to_matrix3(q).reshape(9).tolist())
        for q in (
            quat.from_euler(0.0, EPS, 0.0),
            quat.from_euler(EPS, 0.0, 0.0),
            quat.from_euler(0.0, 0.0, -EPS),
        )
    )


def _solve_ypr_planes(camera, px, py, mu, mv, w, dim: int):
    """Iterative LSQ rotation solve on position/motion/weight planes whose
    point axis is ``dim``; other axes are batch.  Returns (w, x, y, z)."""
    protos = []
    for m in _proto_mats():
        du, dv = delta_planes(camera, px, py, m)
        protos.append((du / EPS, dv / EPS))

    def wsum(x):
        return torch.sum(w * x, dim=dim)

    (p1u, p1v), (p2u, p2v), (p3u, p3v) = protos
    a = (
        wsum(p1u * p1u + p1v * p1v),
        wsum(p1u * p2u + p1v * p2v),
        wsum(p1u * p3u + p1v * p3v),
        wsum(p2u * p2u + p2v * p2v),
        wsum(p2u * p3u + p2v * p3v),
        wsum(p3u * p3u + p3v * p3v),
    )
    rotation = qident_like(a[0])
    for i in range(_LSQ_ITERS):
        alpha = 1.0 if i == _LSQ_ITERS - 1 else ALPHA
        r = tuple(c.unsqueeze(dim) for c in qmat(rotation))
        du, dv = delta_planes(camera, px, py, r)
        vu = mu - du
        vv = mv - dv
        b = (
            wsum(p1u * vu + p1v * vv),
            wsum(p2u * vu + p2v * vv),
            wsum(p3u * vu + p3v * vv),
        )
        m1, m2, m3 = solve3_planes(a, b)
        m1, m2, m3 = m1 * alpha, m2 * alpha, m3 * alpha
        z = torch.zeros_like(m1)
        roll = (torch.cos(m1 * 0.5), z, torch.sin(m1 * 0.5), z)
        pitch = (torch.cos(m2 * 0.5), torch.sin(m2 * 0.5), z, z)
        yaw = (torch.cos(m3 * 0.5), z, z, -torch.sin(m3 * 0.5))
        rotation = qmul(rotation, qmul(pitch, qmul(roll, yaw)))
    # We estimated how points rotate, not how the camera rotates.
    return qconj(rotation)


def solve_ypr_weighted(camera, pos, motion, weights) -> torch.Tensor:
    """Weighted LSQ rotation: ``pos``/``motion`` (..., N, 2), ``weights``
    (..., N).  Returns unit quaternions (..., 4)."""
    q = _solve_ypr_planes(
        camera, pos[..., 0], pos[..., 1], motion[..., 0], motion[..., 1],
        weights, dim=-1,
    )
    return torch.stack(q, dim=-1)


def _inlier_bound(inlier_angle_deg, like: torch.Tensor):
    """Squared inlier angle in radians, in float32 like the JAX package
    (``deg2rad`` then square); a Python number stays on the host."""
    if isinstance(inlier_angle_deg, torch.Tensor):
        t = torch.deg2rad(inlier_angle_deg.to(like.device, torch.float32))
        return (t * t).reshape(like.shape[:-2] + (1, 1)) if t.dim() else t * t
    t = np.float32(inlier_angle_deg) * np.float32(np.pi / 180)
    return float(t * t)


def _take(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """plane (..., N) gathered at idx (..., *shape) along the point axis."""
    lead = plane.shape[:-1]
    idx = idx.expand(lead + idx.shape[-2:]) if idx.dim() == 2 else idx
    flat = idx.reshape(lead + (-1,))
    return torch.gather(plane, -1, flat).reshape(idx.shape)


def solve_ypr_ransac(
    generator: Optional[torch.Generator],
    camera,
    flow: SparseFlow,
    num_iters: int,
    inlier_angle_deg,
    num_samples: int,
    dense: bool = False,
    fit_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """RANSAC over (..., N) flows: ``num_iters`` minimal 3-point fits
    scored on a shared eval subset, then a refit on the winner's inliers.
    Returns (..., 4).

    ``dense=True`` asserts an all-ones mask (static draws and eval subset);
    ``dense=False`` samples and evaluates only valid (mask > 0.5) points.
    ``fit_idx``: optional (H, 3) or (..., H, 3) hypothesis draws, point
    indices or uniforms over the valid points (``ops.robust.as_indices``;
    tests inject the JAX package's); otherwise drawn from ``generator``.
    """
    pos, motion, mask = flow
    n = pos.shape[-2]
    lead = pos.shape[:-2]
    dev = pos.device
    n_eval = min(num_samples, n)
    if dense:
        torch._assert_async(torch.all(mask == 1.0), "dense=True needs an all-ones mask")
    if fit_idx is None:
        fit_idx = (draw_dense(generator, lead, n, num_iters, 3, dev) if dense
                   else sample_indices(generator, n, num_iters, 3, w=mask))
    fit_idx = as_indices(fit_idx.to(dev), mask).to(torch.int64)

    def fit_plane(plane):  # (..., N) -> (..., 3, H)
        return _take(plane, fit_idx).transpose(-1, -2)

    fits = _solve_ypr_planes(
        camera,
        fit_plane(pos[..., 0]), fit_plane(pos[..., 1]),
        fit_plane(motion[..., 0]), fit_plane(motion[..., 1]),
        fit_plane(mask), dim=-2,
    )  # (w, x, y, z) planes, each (..., H)

    if dense:
        eidx, w_e = (x.expand(lead + x.shape) for x in dense_eval_subset(n, n_eval, str(dev)))
    else:
        eidx, w_e = eval_subset(mask, n_eval)

    def eval_plane(plane):  # (..., N) -> (..., S)
        return torch.gather(plane, -1, eidx)

    pxe, pye = eval_plane(pos[..., 0]), eval_plane(pos[..., 1])
    mue, mve = eval_plane(motion[..., 0]), eval_plane(motion[..., 1])

    rcols = tuple(c[..., None] for c in qmat(qconj(fits)))  # (..., H, 1)
    du, dv = delta_planes(camera, pxe[..., None, :], pye[..., None, :], rcols)
    vu = mue[..., None, :] - du
    vv = mve[..., None, :] - dv
    au, av = point_angle_planes(camera, pxe[..., None, :] + du, pye[..., None, :] + dv)
    err2 = (vu * torch.cos(au)) ** 2 + (vv * torch.cos(av)) ** 2
    inliers = (err2 <= _inlier_bound(inlier_angle_deg, pos)) & (w_e[..., None, :] > 0.5)  # (..., H, S)
    counts = inliers.sum(dim=-1)
    best = torch.argmax(counts, dim=-1, keepdim=True)  # first maximum
    best_count = torch.gather(counts, -1, best)
    best_w = torch.gather(
        inliers, -2, best[..., None].expand(best.shape + (inliers.shape[-1],))
    ).squeeze(-2).to(torch.float32)
    refit = torch.stack(
        _solve_ypr_planes(camera, pxe, pye, mue, mve, best_w, dim=-1), dim=-1
    )
    return torch.where(best_count >= 3, refit, quat.identity(device=dev))


@register("almeida")
def make_almeida(**kwargs) -> EstimatorInstance:
    params = AlmeidaParams(**kwargs)

    def estimate(state, flow: SparseFlow, camera, generator=None, props=None,
                 dense=False, fit_idx=None, move_magnitude=None):
        # ``move_magnitude`` is accepted and unused, as in the reference.
        inlier_deg = (props or {}).get("inlier_angle_deg", params.inlier_angle_deg)
        if params.use_ransac:
            rot = solve_ypr_ransac(
                generator, camera, flow, params.num_iters, inlier_deg,
                params.ransac_samples, dense=dense, fit_idx=fit_idx,
            )
        else:
            rot = solve_ypr_weighted(camera, flow.pos, flow.motion, flow.mask)
        tr = torch.zeros(rot.shape[:-1] + (3,), dtype=torch.float32, device=rot.device)
        return rot, tr, state

    return EstimatorInstance(
        name="almeida",
        params=params,
        init=lambda: (),
        estimate=estimate,
        dyn_defaults=lambda: {"inlier_angle_deg": params.inlier_angle_deg},
        draw=(
            (lambda generator, lead, n, device, dense=True: draw(
                generator, lead, n, params.num_iters, 3, device, dense))
            if params.use_ransac else None
        ),
    )
