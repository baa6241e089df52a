"""Homography camera-rotation estimator (port of
``ofps_tpu.estimators.homography``).

A robust homography over the flow correspondences (RANSAC with the
adaptive threshold, progressive prescore and LO refits, or LMedS), then a
weighted DLT refit on the winning inliers and a Gauss-Newton polish, the
sign fixed by positive depth on the inliers, the decomposition with the
camera intrinsics, the rotation of the minimum-translation solution, and
the axis remap to the codebase convention.  All B streams of a batch and
all hypotheses run at once on leading dims.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ofps_torch.core import quat
from ofps_torch.core.motion import SparseFlow
from ofps_torch.estimators.base import EstimatorInstance, camera_intrinsics, register
from ofps_torch.estimators.convention import remap_solver_rotation
from ofps_torch.kernels import homography as kh
from ofps_torch.ops.epipolar import homogeneous, transform_points
from ofps_torch.ops.homography import (
    decompose_homography,
    dlt_homography,
    gn_refine_homography,
    homography_transfer_error,
)
from ofps_torch.ops.robust import draw, ransac_budget, robust_fit


class HomographyParams(NamedTuple):
    desired_confidence: float = 0.997
    max_error: float = 0.001
    max_iters: int = 2000
    use_ransac: bool = True
    num_hypotheses: int = 512
    outlier_proba: float = 0.5
    eval_cap: int = 2048
    # LMedS-sigma floor on the RANSAC cut for noisy fields (ops.robust).
    adaptive_threshold: bool = True
    # Progressive scoring: a 128-point prescore, 32 finalists.
    prescore_cap: int = 128
    finalists: int = 32


def hypothesis_count(params: HomographyParams) -> int:
    """RANSAC batch size: 91 at the defaults."""
    return ransac_budget(
        params.desired_confidence, params.outlier_proba, 4,
        min(params.num_hypotheses, params.max_iters),
    )


def _minimal(x1s, x2s, ws):
    h = dlt_homography(x1s, x2s, ws)
    return h[..., None, :, :], torch.ones(h.shape[:-2] + (1,), dtype=torch.bool, device=h.device)


def rotation_candidates(h: torch.Tensor, camera):
    """The two decomposition families of ``h`` (..., 3, 3): their rotations
    as quaternions in the codebase convention (..., 2, 4) and their
    squared translation norms (..., 2).

    The estimator takes the family of the smaller norm (the first on a
    tie).  In exact arithmetic both norms equal s1 - s3 (n is a unit
    vector in both families), so outside the pure-rotation branch that
    choice is made by rounding, here as in the JAX package."""
    rs, ts, _ = decompose_homography(h, camera_intrinsics(camera, str(h.device))[0])
    # x2 ~ (R + t n^T) x1 lands one inverse away from the reference's
    # OpenCV output: the calibrated remap is the (w, -x, -z, y) swap.
    return remap_solver_rotation(quat.from_matrix3(rs)), torch.sum(ts * ts, dim=-1)


def ransac_plain(flow: SparseFlow, camera, params: HomographyParams, num_hypotheses: int,
                 threshold, dense: bool = False, idx: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> kh.Fit:
    """The plain version of ``kernels/homography.ransac``: ``robust_fit``
    with the estimator's settings, the weighted refit on the winning
    inliers and its Gauss-Newton polish, the sign fixed by positive depth
    on the inliers, then :func:`rotation_candidates` and the first minimum.
    ``idx`` (..., H, 4): the RANSAC draws (else drawn from ``generator``)."""
    p1, w = flow.pos, flow.mask
    p2 = flow.pos + flow.motion
    res = robust_fit(
        p1, p2, w,
        minimal_fit=_minimal,
        sample_size=4,
        error_fn=homography_transfer_error,
        num_hypotheses=num_hypotheses,
        threshold=threshold,
        use_lmeds=not params.use_ransac,
        eval_cap=params.eval_cap,
        adaptive_threshold=params.adaptive_threshold,
        refit_fn=dlt_homography,
        prescore_cap=params.prescore_cap,
        finalists=params.finalists,
        dense=dense,
        idx=idx,
        generator=generator,
    )
    # Weighted refit on the winning inlier set + Gauss-Newton polish.
    h = dlt_homography(p1, p2, res.inliers)
    h = gn_refine_homography(h, p1, p2, res.inliers)

    # Sign disambiguation before decomposition: x2n . (Hn x1n) > 0 on the
    # consensus set (positive depth), with xn = K^-1 x.
    kinv = camera_intrinsics(camera, str(p1.device))[1]
    a = transform_points(homogeneous(p1), torch.matmul(kinv, h))
    b = transform_points(homogeneous(p2), kinv)
    sign = torch.sign(torch.sum(torch.sum(a * b, dim=-1) * res.inliers, dim=-1))
    h = h * torch.where(sign == 0, 1.0, sign)[..., None, None]
    quats, tnorm = rotation_candidates(h, camera)
    best = torch.argmin(tnorm, dim=-1)  # first minimum
    rot = torch.gather(quats, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    return kh.Fit(rot, quats, tnorm, h, res)


def estimate_homography_rotation(
    generator: Optional[torch.Generator], params: HomographyParams, flow: SparseFlow,
    camera, max_error=None, dense: bool = False, fit_idx: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> torch.Tensor:
    """Rotation quaternions (..., 4) of flows (..., N): the family of the
    minimum translation norm (:func:`rotation_candidates`).  On a CUDA
    flow the fit and everything after it are the hand kernels
    (``kernels/homography.ransac``) unless ``plain``, or parameters or
    shapes they do not cover (``kernels/homography.on_kernels``): then
    :func:`ransac_plain`."""
    hyps = hypothesis_count(params) if fit_idx is None else fit_idx.shape[-2]
    fit = kh.ransac if kh.on_kernels(params, flow.pos, hyps, plain) else ransac_plain
    return fit(flow, camera, params, hypothesis_count(params),
               params.max_error if max_error is None else max_error, dense, fit_idx,
               generator).rot


@register("homography")
def make_homography(**kwargs) -> EstimatorInstance:
    params = HomographyParams(**kwargs)
    h_count = hypothesis_count(params)

    def estimate(state, flow: SparseFlow, camera, generator=None, props=None,
                 dense=False, fit_idx=None, move_magnitude=None, plain=False):
        # ``move_magnitude`` is accepted and unused, as in the reference;
        # ``plain`` runs the fit's plain version in place of its kernels.
        rot = estimate_homography_rotation(
            generator, params, flow, camera,
            max_error=(props or {}).get("max_error"), dense=dense, fit_idx=fit_idx,
            plain=plain,
        )
        # Degenerate input guard: fewer valid points than a minimal sample.
        ok = (torch.sum(flow.mask, dim=-1) >= 4) & torch.isfinite(rot).all(-1)
        rot = torch.where(ok[..., None], rot, quat.identity(device=rot.device))
        tr = torch.zeros(rot.shape[:-1] + (3,), dtype=torch.float32, device=rot.device)
        return rot, tr, state

    return EstimatorInstance(
        name="homography",
        params=params,
        init=lambda: (),
        estimate=estimate,
        dyn_defaults=lambda: {"max_error": float(params.max_error)},
        draw=lambda generator, lead, n, device, dense=True: draw(
            generator, lead, n, h_count, 4, device, dense),
    )
