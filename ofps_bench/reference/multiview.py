# Frozen copy of the port's plain ``ofps_torch/estimators/multiview.py`` (the benchmark's
# reference; it imports nothing of the port).
"""Essential-matrix camera-rotation estimator, "multiview" (port of
``ofps_tpu.estimators.multiview``).

A robust essential matrix over the flow correspondences in normalized
camera coordinates (RANSAC over Nistér 5-point samples, 28 candidates
each, with the progressive prescore, the adaptive threshold and LO refits
of 8-point fits projected onto the essential manifold), a refit on the
inliers, pose recovery by cheirality, a Gauss-Newton polish on the motion
manifold, the rotation-only fallback for near pure rotation, the axis
remap and the >90 degree wraparound fix.  All B streams of a batch and all
hypotheses run at once on leading dims.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ofps_bench.reference import quat
from ofps_bench.reference.motion import SparseFlow
from ofps_bench.reference.est_base import EstimatorInstance, camera_intrinsics, register
from ofps_bench.reference.convention import remap_solver_rotation
from ofps_bench.reference.epipolar import (
    eight_point_fundamental,
    homogeneous,
    project_to_essential,
    recover_pose_from_essential,
    refine_pose_sampson,
    rotation_only_fallback,
    sampson_error,
    transform_points,
)
from ofps_bench.reference.five_point import five_point_essential
from ofps_bench.reference.robust import draw, ransac_budget, robust_fit


class MultiviewParams(NamedTuple):
    """``num_hypotheses`` is the ceiling on the hypothesis batch; the count
    is the RANSAC bound of ``desired_confidence`` at the ``outlier_proba``
    prior (218 at the defaults).  ``use_five_point=False`` takes the
    8-point fit projected onto E as the minimal solver."""

    desired_confidence: float = 0.999
    max_error: float = 0.0001
    use_ransac: bool = True
    num_hypotheses: int = 512
    outlier_proba: float = 0.5
    use_five_point: bool = True
    eval_cap: int = 2048
    prescore_cap: int = 128
    finalists: int = 32
    rotation_fallback: bool = True
    adaptive_threshold: bool = True
    gn_polish: bool = True
    gn_iters: int = 3


def sample_size(params: MultiviewParams) -> int:
    return 5 if params.use_five_point else 8


def hypothesis_count(params: MultiviewParams) -> int:
    """RANSAC batch size: 218 at the defaults (6,104 candidate models)."""
    return ransac_budget(params.desired_confidence, params.outlier_proba,
                         sample_size(params), params.num_hypotheses)


def normalized_coords(kinv: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Screen points (..., N, 2) in normalized camera coordinates."""
    h = transform_points(homogeneous(p), kinv)
    return h[..., :2] / h[..., 2:3]


def _eight_point_essential(x1, x2, w):
    return project_to_essential(eight_point_fundamental(x1, x2, w))


def _minimal_eight(x1s, x2s, ws):
    e = _eight_point_essential(x1s, x2s, ws)
    return e[..., None, :, :], torch.ones(e.shape[:-2] + (1,), dtype=torch.bool, device=e.device)


def estimate_essential_rotation(
    generator: Optional[torch.Generator], params: MultiviewParams, flow: SparseFlow,
    camera, max_error=None, dense: bool = False, fit_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Rotation quaternions (..., 4) of flows (..., N).  ``fit_idx`` (...,
    H, k): the RANSAC draws (else drawn from ``generator``)."""
    k, kinv = camera_intrinsics(camera, str(flow.pos.device))
    w = flow.mask
    x1 = normalized_coords(kinv, flow.pos)
    x2 = normalized_coords(kinv, flow.pos + flow.motion)
    if max_error is None:
        max_error = params.max_error
    # The pixel threshold over the focal length, as OpenCV does for
    # normalized coordinates (K is in [0, 1] screen units).
    thr = max_error / ((k[0, 0] + k[1, 1]) * 0.5)
    res = robust_fit(
        x1, x2, w,
        minimal_fit=five_point_essential if params.use_five_point else _minimal_eight,
        sample_size=sample_size(params),
        error_fn=sampson_error,
        num_hypotheses=hypothesis_count(params),
        threshold=thr,
        use_lmeds=not params.use_ransac,
        eval_cap=params.eval_cap,
        adaptive_threshold=params.adaptive_threshold,
        prescore_cap=params.prescore_cap,
        finalists=params.finalists,
        dense=dense,
        refit_fn=_eight_point_essential,
        idx=fit_idx,
        generator=generator,
    )
    # Refit on the inliers, then the pose by a cheirality vote over them.
    e = _eight_point_essential(x1, x2, res.inliers)
    r, t, _ = recover_pose_from_essential(e, x1, x2, res.inliers)
    if params.gn_polish:
        r, t = refine_pose_sampson(r, t, x1, x2, res.inliers, iters=params.gn_iters)
    if params.rotation_fallback:
        r, _ = rotation_only_fallback(r, x1, x2, res.inliers)
    q = remap_solver_rotation(quat.from_matrix3(r))
    # >90 degree wraparound fix.
    axis, ang = quat.axis_angle(q)
    q_fixed = quat.from_axis_angle(axis, torch.remainder(ang + math.pi, 2.0 * math.pi))
    return torch.where((ang > math.pi / 2.0)[..., None], q_fixed, q)


@register("multiview")
def make_multiview(**kwargs) -> EstimatorInstance:
    params = MultiviewParams(**kwargs)
    h_count, k = hypothesis_count(params), sample_size(params)

    def estimate(state, flow: SparseFlow, camera, generator=None, props=None,
                 dense=False, fit_idx=None, move_magnitude=None, plain=False):
        # ``move_magnitude`` is accepted and unused, as in the reference;
        # ``plain`` too, with no hand kernel to stand in for.
        rot = estimate_essential_rotation(
            generator, params, flow, camera,
            max_error=(props or {}).get("max_error"), dense=dense, fit_idx=fit_idx,
        )
        ok = (torch.sum(flow.mask, dim=-1) >= 8) & torch.isfinite(rot).all(-1)
        rot = torch.where(ok[..., None], rot, quat.identity(device=rot.device))
        tr = torch.zeros(rot.shape[:-1] + (3,), dtype=torch.float32, device=rot.device)
        return rot, tr, state

    return EstimatorInstance(
        name="multiview",
        params=params,
        init=lambda: (),
        estimate=estimate,
        dyn_defaults=lambda: {"max_error": float(params.max_error)},
        draw=lambda generator, lead, n, device, dense=True: draw(
            generator, lead, n, h_count, k, device, dense),
    )
