"""Almeida camera-rotation estimator: iterative least squares + RANSAC
(port of ``ofps_tpu.estimators.almeida``).

All hypotheses of a batch of streams are fitted and scored at once on
``(B, 3, H)`` / ``(B, H, S)`` planes, then the winning inlier set is refit.
``dense=True`` (the serving configuration's all-valid densified grid) takes
static draws and a static eval subset (``ops.robust.dense_eval_indices``);
``dense=False`` draws valid points with the masked sampler and compacts the
eval subset from the mask at run time (``ops.robust.eval_subset``).  The fits,
the scoring and the refit are ``kernels/almeida.ransac``: three hand-kernel
launches on CUDA, its plain version (``ransac_plain``) on the CPU and with
``plain=True``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ofps_torch.core.motion import SparseFlow
from ofps_torch.estimators.base import EstimatorInstance, register
from ofps_torch.kernels import almeida as kalm
from ofps_torch.ops.robust import (
    as_indices,
    dense_eval_subset,
    draw,
    draw_dense,
    eval_subset,
    sample_indices,
)


class AlmeidaParams(NamedTuple):
    use_ransac: bool = True
    num_iters: int = 200
    inlier_angle_deg: float = 0.05
    ransac_samples: int = 1000


def solve_ypr_weighted(camera, pos, motion, weights) -> torch.Tensor:
    """Weighted LSQ rotation: ``pos``/``motion`` (..., N, 2), ``weights``
    (..., N).  Returns unit quaternions (..., 4)."""
    q = kalm.solve_ypr_planes(
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


def solve_ypr_ransac(
    generator: Optional[torch.Generator],
    camera,
    flow: SparseFlow,
    num_iters: int,
    inlier_angle_deg,
    num_samples: int,
    dense: bool = False,
    fit_idx: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> torch.Tensor:
    """RANSAC over (..., N) flows: ``num_iters`` minimal 3-point fits
    scored on a shared eval subset, then a refit on the winner's inliers.
    Returns (..., 4).

    ``dense=True`` asserts an all-ones mask (static draws and eval subset);
    ``dense=False`` samples and evaluates only valid (mask > 0.5) points.
    ``fit_idx``: optional (H, 3) or (..., H, 3) hypothesis draws, point
    indices or uniforms over the valid points (``ops.robust.as_indices``;
    tests inject the JAX package's); otherwise drawn from ``generator``.
    The fits, the scoring and the refit are ``kernels/almeida.ransac``
    (``plain=True``: its plain version on any device).
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
    if dense:
        eidx, w_e = (x.expand(lead + x.shape) for x in dense_eval_subset(n, n_eval, str(dev)))
    else:
        eidx, w_e = eval_subset(mask, n_eval)
    rot, _, _ = kalm.ransac(camera, flow, fit_idx, eidx, w_e,
                            _inlier_bound(inlier_angle_deg, pos), plain=plain)
    return rot


@register("almeida")
def make_almeida(**kwargs) -> EstimatorInstance:
    params = AlmeidaParams(**kwargs)

    def estimate(state, flow: SparseFlow, camera, generator=None, props=None,
                 dense=False, fit_idx=None, move_magnitude=None, plain=False):
        # ``move_magnitude`` is accepted and unused, as in the reference.
        inlier_deg = (props or {}).get("inlier_angle_deg", params.inlier_angle_deg)
        if params.use_ransac:
            rot = solve_ypr_ransac(
                generator, camera, flow, params.num_iters, inlier_deg,
                params.ransac_samples, dense=dense, fit_idx=fit_idx, plain=plain,
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
