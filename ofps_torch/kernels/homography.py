"""Homography's robust fit and everything after it (``ops/robust.robust_fit``
over 4-point DLT samples, the weighted DLT refit on the winning inliers,
the Gauss-Newton polish, the positive-depth sign, both decomposition
families and the first minimum of their translation norms) in three
launches of the kernels of ``csrc/homography_ransac.cu`` (:func:`ransac`).
Its plain version is ``estimators/homography.ransac_plain``, which the
estimator runs where :func:`on_kernels` is false.

The kernels take the flow's points, the hypotheses' point indices and the
eval subset (masked draws and the masked eval subset are mapped to point
indices here, by ``ops/robust``'s own functions).  The candidates, the
adapted cut, the finalists and the winner are the plain version's on the
card bit for bit; the refit's sums over all the points take the kernel's
order, so its rotation is the plain version's within 1e-6 rad.  The
threshold is a device pointer when it is a tensor (the ``max_error`` prop
of the consumers' graph), so a new value is a copy into the graph's input,
not a new graph.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ofps_torch.kernels import build
from ofps_torch.ops import robust
from ofps_torch.ops.solve import _start_block

MAX_PRESCORE = 128  # prescore points (kMaxPrescore)
MAX_FINALISTS = 32  # finalists (kMaxFinalists)
MAX_EVAL = 8192  # eval points (kMaxEval, staged in shared memory)
LO_ITERS = 2  # robust_fit's LO rounds
GN_ITERS = 3  # gn_refine_homography's steps
LAUNCHES = 3  # a call of ransac: fit, score, refit


class Fit(NamedTuple):
    rot: torch.Tensor  # (..., 4) the rotation of the smaller translation norm
    quats: torch.Tensor  # (..., 2, 4) both decomposition families' rotations
    tnorm: torch.Tensor  # (..., 2) their squared translation norms
    h: torch.Tensor  # (..., 3, 3) the refined, sign-fixed homography
    fit: robust.RobustResult  # the RANSAC's LO model, inliers, their count, winner


def uses_kernels(params) -> bool:
    """Whether ``HomographyParams`` ``params`` are ones the kernels cover:
    RANSAC with the adaptive threshold, a prescore of at most MAX_PRESCORE
    points, at most MAX_FINALISTS finalists and an eval subset of at most
    MAX_EVAL points (every configuration's defaults).  Others
    (``use_ransac=False``, ...) take the plain version on every device."""
    return bool(params.use_ransac and params.adaptive_threshold
                and 0 < params.prescore_cap <= MAX_PRESCORE
                and 0 < params.finalists <= MAX_FINALISTS
                and 0 < params.eval_cap <= MAX_EVAL)


def on_kernels(params, x: torch.Tensor, hypotheses: int, plain: bool = False) -> bool:
    """Whether homography's fit of ``hypotheses`` samples over points ``x``
    (..., N, 2) runs on the kernels: a CUDA tensor, parameters they cover
    (:func:`uses_kernels`), shapes that ``robust_fit`` prescores (more eval
    points than the prescore's and more hypotheses than finalists) and not
    ``plain``.  A CPU tensor takes the plain version; any other device
    raises."""
    return (not plain and uses_kernels(params)
            and params.prescore_cap < min(params.eval_cap, x.shape[-2])
            and params.finalists < hypotheses
            and build.on_cuda("homography_ransac", x))


_P = ctypes.c_void_p
_L = ctypes.c_int64


class _Args(ctypes.Structure):
    """``Args`` of ``csrc/homography_ransac.cu``, field for field."""

    _fields_ = [
        (name, _P) for name in (
            "pos", "motion", "mask", "idx", "eidx", "we", "thr", "models", "valid", "med", "pre",
            "thr2", "cand", "best", "model", "out_h", "out_q", "out_tn", "out_rot", "out_inl",
            "out_score", "flags")
    ] + [
        (name, _L) for name in ("pos_sb", "pos_sn", "mot_sb", "mot_sn", "mask_sb", "mask_sn",
                                "idx_sb", "eidx_sb", "we_sb", "thr_sb")
    ] + [
        ("thr_value", ctypes.c_float),
        ("sigma_c", ctypes.c_float),
        ("start", ctypes.c_float * 9),
        ("k", ctypes.c_float * 9),
    ] + [(name, ctypes.c_int) for name in ("B", "N", "H", "S", "P", "F", "lo_iters", "gn_iters")]


# robust_fit's 2.5 * 1.4826 (the LMedS 2.5-sigma cut), as PyTorch
# multiplies by it: in float32.
SIGMA_C = float(np.float32(2.5 * 1.4826))


@functools.lru_cache(maxsize=16)
def _intrinsics(camera) -> tuple:
    """The camera's K (row-major) as 9 floats."""
    return tuple(camera.intrinsics().reshape(-1).tolist())


@functools.lru_cache(maxsize=1)
def _start() -> tuple:
    """The inverse iteration's (9, 1) start block as 9 floats."""
    return tuple(_start_block(9, 1, "cpu").reshape(-1).tolist())


def _launch(flow, camera, params, num_hypotheses: int, threshold, dense, idx, generator):
    """Launch the three kernels; returns every buffer they write, by name:
    the candidates (``models``, ``valid``), the prescore medians and counts
    (``med``, ``pre``), the adapted squared cut (``thr2``), the finalists
    (``cand``), the winner (``best``), the LO model (``model``), the refined
    homography (``h``), both families (``quats``, ``tnorm``), the pick
    (``rot``), the final inliers (``inliers``), their count (``score``) and
    the refit's scratch inlier sets (``flags``)."""
    pos, motion, w = flow
    lead, n = pos.shape[:-2], pos.shape[-2]
    bsz = math.prod(lead)
    dev = pos.device
    if idx is None:  # robust_fit's own draws
        if dense:
            idx = robust.draw_dense(generator, lead, n, num_hypotheses, 4, dev)
        else:
            idx = robust.sample_indices(generator, n, num_hypotheses, 4, w=w)
    idx = robust.as_indices(idx.to(dev), w).to(torch.int64)
    h = idx.shape[-2]
    if idx.shape[-1] != 4:
        raise ValueError(f"homography_ransac: needs (H, 4) draws, got {tuple(idx.shape)}")
    cap = params.eval_cap
    if cap and cap < n:
        if dense:
            eidx, we = robust.dense_eval_subset(n, cap, str(dev))
        else:
            eidx, we = robust.eval_subset(w, cap)
    else:
        eidx, we = robust._arange(n, str(dev)), w
    s = eidx.shape[-1]
    p_cap, f_cap = params.prescore_cap, params.finalists
    if not (p_cap < s and f_cap < h):
        raise ValueError(
            f"homography_ransac: the prescore needs more than {p_cap} eval points and more "
            f"than {f_cap} hypotheses, got {s} and {h}")
    f32 = torch.float32

    def rows(x, tail, dtype, name, dense_axes=1):
        return build.batch_rows("homography_ransac", x, lead, tail, dtype, name, dense_axes)

    pos = rows(pos, (n, 2), f32, "pos")
    motion = rows(motion, (n, 2), f32, "motion")
    w = rows(w, (n,), f32, "mask", 0)
    idx = rows(idx, (h, 4), torch.int64, "idx", 2)
    eidx = rows(eidx, (s,), torch.int64, "eidx")
    we = rows(we, (s,), f32, "we")
    thr, thr_value, thr_sb = None, 0.0, 0
    if isinstance(threshold, torch.Tensor):
        thr = threshold.to(dev, f32).reshape(-1)
        if thr.numel() not in (1, bsz):
            raise ValueError(f"homography_ransac: {thr.numel()} thresholds for {bsz} streams")
        thr_sb = 0 if thr.numel() == 1 else thr.stride(0)
    else:
        thr_value = float(np.float32(threshold))
    for t in (motion, w, idx, eidx, we):
        if t.device != dev:
            raise ValueError(f"homography_ransac: tensors on {t.device} and {dev}")
    out = {
        "models": torch.empty((bsz, h, 3, 3), dtype=f32, device=dev),
        "valid": torch.empty((bsz, h), dtype=torch.int32, device=dev),
        "med": torch.empty((bsz, h), dtype=f32, device=dev),
        "pre": torch.empty((bsz, h), dtype=torch.int32, device=dev),
        "thr2": torch.empty((bsz,), dtype=f32, device=dev),
        "cand": torch.empty((bsz, f_cap), dtype=torch.int64, device=dev),
        "best": torch.empty((bsz,), dtype=torch.int64, device=dev),
        "model": torch.empty((bsz, 3, 3), dtype=f32, device=dev),
        "h": torch.empty((bsz, 3, 3), dtype=f32, device=dev),
        "quats": torch.empty((bsz, 2, 4), dtype=f32, device=dev),
        "tnorm": torch.empty((bsz, 2), dtype=f32, device=dev),
        "rot": torch.empty((bsz, 4), dtype=f32, device=dev),
        "inliers": torch.empty((bsz, n), dtype=f32, device=dev),
        "score": torch.empty((bsz,), dtype=f32, device=dev),
        "flags": torch.empty((bsz, 2, n), dtype=torch.uint8, device=dev),
    }

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = _Args(
        *(ptr(t) for t in (pos, motion, w, idx, eidx, we, thr)),
        *(out[key].data_ptr() for key in ("models", "valid", "med", "pre", "thr2", "cand", "best",
                                          "model", "h", "quats", "tnorm", "rot", "inliers",
                                          "score", "flags")),
        pos.stride(0), pos.stride(1), motion.stride(0), motion.stride(1), w.stride(0), w.stride(1),
        idx.stride(0), eidx.stride(0), we.stride(0), thr_sb,
        thr_value, SIGMA_C, (ctypes.c_float * 9)(*_start()),
        (ctypes.c_float * 9)(*_intrinsics(camera)),
        bsz, n, h, s, p_cap, f_cap, LO_ITERS, GN_ITERS,
    )
    lib = build.library()
    with build.on_device(dev):
        status = lib.ofps_homography_ransac(ctypes.byref(args), build.stream_ptr(dev))
    build.check(status, "ofps_homography_ransac")
    ransac.launches += LAUNCHES
    return out


def ransac(flow, camera, params, num_hypotheses: int, threshold, dense: bool = False,
           idx: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> Fit:
    """Homography's robust fit over a (..., N) flow on the kernels, refined,
    sign-fixed and decomposed: the rotation of the smaller translation
    norm, both families' rotations and norms, the homography and the
    RANSAC's result (LO model, final inliers, their count, the winning
    hypothesis); for a case :func:`on_kernels` takes.

    ``threshold``: the inlier cut in screen units, a number or a tensor
    (0-d or one per stream); ``params``: the estimator's
    ``HomographyParams``; ``idx`` (..., H, 4) or (H, 4): the draws, point
    indices or uniforms (else drawn from ``generator``).
    """
    return fit_of(_launch(flow, camera, params, num_hypotheses, threshold, dense, idx, generator),
                  flow.pos.shape[:-2])


def fit_of(out, lead) -> Fit:
    """The :class:`Fit` of :func:`_launch`'s buffers, for streams ``lead``."""
    n = out["inliers"].shape[-1]
    res = robust.RobustResult(
        model=out["model"].reshape(lead + (3, 3)),
        inliers=out["inliers"].reshape(lead + (n,)),
        score=out["score"].reshape(lead),
        best=out["best"].reshape(lead),
    )
    return Fit(out["rot"].reshape(lead + (4,)), out["quats"].reshape(lead + (2, 4)),
               out["tnorm"].reshape(lead + (2,)), out["h"].reshape(lead + (3, 3)), res)


ransac.launches = 0  # kernel launches (LAUNCHES a call of ransac)
