"""Multiview's robust essential-matrix fit: the RANSAC's plain version
(:func:`ransac_plain`, the CPU path: ``ops/robust.robust_fit`` over
``ops/five_point.five_point_essential`` samples, then the refit on the
inliers) and the same on the kernels of ``csrc/multiview_ransac.cu``
(:func:`ransac`).

Four launches take the normalized coordinates, the hypotheses' point
indices and the eval subset (masked draws and the masked eval subset are
mapped to point indices here, by ``ops/robust``'s own functions), fit the
five-point candidates, prescore them with the adaptive cut, count the
finalists and pick the winner with its inliers.  The LO rounds and the
final refit follow ``robust_fit``'s code: their sums over the points are
PyTorch's, and each eight-point fit's small algebra is one launch
(:func:`eight_point_essential`).  On the card the results are the plain
version's bit for bit at the shapes the kernels were matched to
(``csrc/multiview_ransac.cu``).  The threshold is a device pointer (from
the ``max_error`` prop of the consumers' graph), so a new value is a copy
into the graph's input, not a new graph.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ofps_torch.kernels import build
from ofps_torch.ops import five_point as fp
from ofps_torch.ops import robust
from ofps_torch.ops.epipolar import eight_point_fundamental, project_to_essential, sampson_error
from ofps_torch.ops.solve import _start_block

MODELS = 28  # candidates a hypothesis: two charts of 14
MAX_PRESCORE = 128  # prescore points (kMaxPrescore)
MAX_FINALISTS = 32  # finalists (kMaxFinalists)
LO_ITERS = 2  # robust_fit's LO rounds
# A call of ransac: fit, prescore, count, select; three an eight-point fit
# (the distances, the normal matrix's terms, the solve), one for each LO
# round and one for the final refit; and one for each LO round's scoring.
# The estimator's normalized_coords adds one.
LAUNCHES = 4 + 3 * (LO_ITERS + 1) + LO_ITERS


class Fit(NamedTuple):
    e: torch.Tensor  # (..., 3, 3) the refit on the inliers
    fit: robust.RobustResult  # the RANSAC's model, inliers, score, best


def _eight_point_essential(x1, x2, w):
    return project_to_essential(eight_point_fundamental(x1, x2, w))


def _minimal_eight(x1s, x2s, ws):
    e = _eight_point_essential(x1s, x2s, ws)
    return e[..., None, :, :], torch.ones(e.shape[:-2] + (1,), dtype=torch.bool, device=e.device)


def on_kernels(params, x: torch.Tensor, plain: bool = False) -> bool:
    """Whether multiview's RANSAC for points ``x`` runs on the kernels: a
    CUDA tensor, parameters they cover (:func:`uses_kernels`) and not
    ``plain``.  A CPU tensor takes the plain version; any other device
    raises."""
    return not plain and uses_kernels(params) and build.on_cuda("multiview_ransac", x)


def uses_kernels(params) -> bool:
    """Whether ``MultiviewParams`` ``params`` are ones the kernels cover:
    five-point RANSAC with the adaptive threshold, a prescore of at most
    MAX_PRESCORE points and at most MAX_FINALISTS finalists (every
    configuration's defaults).  Others (``use_five_point=False``,
    ``use_ransac=False``, ...) take the plain version on every device."""
    return bool(params.use_five_point and params.use_ransac and params.adaptive_threshold
                and 0 < params.prescore_cap <= MAX_PRESCORE
                and 0 < params.finalists <= MAX_FINALISTS)


def ransac_plain(x1, x2, w, threshold, params, num_hypotheses: int,
                 idx: Optional[torch.Tensor] = None, dense: bool = False,
                 generator: Optional[torch.Generator] = None) -> Fit:
    """The plain version of :func:`ransac`: ``robust_fit`` with multiview's
    settings (``params``, a ``MultiviewParams``), then the eight-point
    essential refit on its inliers."""
    res = robust.robust_fit(
        x1, x2, w,
        minimal_fit=fp.five_point_essential if params.use_five_point else _minimal_eight,
        sample_size=5 if params.use_five_point else 8,
        error_fn=sampson_error,
        num_hypotheses=num_hypotheses,
        threshold=threshold,
        use_lmeds=not params.use_ransac,
        eval_cap=params.eval_cap,
        adaptive_threshold=params.adaptive_threshold,
        prescore_cap=params.prescore_cap,
        finalists=params.finalists,
        dense=dense,
        refit_fn=_eight_point_essential,
        idx=idx,
        generator=generator,
    )
    return Fit(_eight_point_essential(x1, x2, res.inliers), res)


_CONSTS = 6852  # kConsts: the floats of _tables
_START1 = _CONSTS - 9  # kStart1: the eight-point's (9, 1) start block


@functools.lru_cache(maxsize=8)
def _tables(device: str) -> torch.Tensor:
    """The kernels' constants (``Args::consts``, offsets kPX .. kStart1):
    ``ops/five_point``'s float32 tables and the inverse iteration's start
    blocks, copied to the device once (the capture's eager warm-up call
    makes the copy, outside the graph)."""
    parts = [
        np.asarray(fp._P20, np.float32), fp._V20_INV, fp._TRIG_INV, fp._SC4_N, fp._COS2_N,
        fp._GRID_B, fp._GRID_THJ, fp._HADAMARD4,
        _start_block(9, 4, "cpu").numpy(), _start_block(9, 1, "cpu").numpy(),
    ]
    flat = np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in parts])
    if flat.size != _CONSTS:
        raise AssertionError(f"multiview_ransac: {flat.size} constants, the kernels take {_CONSTS}")
    return torch.from_numpy(flat).to(device)


_P = ctypes.c_void_p
_L = ctypes.c_int64


class _PointArgs(ctypes.Structure):
    """``PointArgs`` of ``csrc/multiview_ransac.cu``, field for field."""

    _pointers = ("a", "b", "w", "m", "m2", "s1", "s2", "o1", "o2", "o3")
    _fields_ = [(name, _P) for name in _pointers] + [("B", ctypes.c_int), ("N", ctypes.c_int)]


# mv_points_kernel's stages (``Stage``).
NORMALIZE, DISTANCES, NORMAL_ROWS, LO_SCORE = range(4)


def _points(stage: int, bsz: int, n: int, dev, **tensors) -> None:
    """One launch of ``mv_points_kernel`` at ``stage`` over (bsz, n) points;
    ``tensors`` by ``PointArgs`` field name (each packed)."""
    args = _PointArgs(*(None if tensors.get(f) is None else tensors[f].data_ptr()
                        for f in _PointArgs._pointers), bsz, n)
    lib = build.library()
    with build.on_device(dev):
        status = lib.ofps_multiview_points(ctypes.byref(args), stage, build.stream_ptr(dev))
    build.check(status, "ofps_multiview_points")
    ransac.launches += 1


def _packed(x: torch.Tensor, lead, tail, name: str) -> torch.Tensor:
    """``x`` as packed (B, *tail) float32 rows, the layout the point-indexed
    kernels read (a batch broadcast with stride 0, as a dense lattice's
    positions and mask are, is copied)."""
    return build.batch_rows("multiview_ransac", x, lead, tail, torch.float32, name, len(tail) + 1)


def normalized_coords(kinv: torch.Tensor, pos: torch.Tensor, motion: torch.Tensor):
    """The estimator's normalized coordinates of ``pos`` and ``pos +
    motion`` (..., N, 2) on the card, in one launch: its
    ``normalized_coords`` bit for bit."""
    lead, n = pos.shape[:-2], pos.shape[-2]
    bsz = math.prod(lead)
    f32 = torch.float32
    pos, motion = (_packed(x, lead, (n, 2), name) for x, name in ((pos, "pos"), (motion, "motion")))
    x1, x2 = (torch.empty((bsz, n, 2), dtype=f32, device=pos.device) for _ in range(2))
    _points(NORMALIZE, bsz, n, pos.device, a=pos, b=motion, m=kinv.to(f32).contiguous(),
            o1=x1, o2=x2)
    return x1.reshape(lead + (n, 2)), x2.reshape(lead + (n, 2))


class _Args(ctypes.Structure):
    """``Args`` of ``csrc/multiview_ransac.cu``, field for field."""

    _fields_ = [
        (name, _P) for name in (
            "x1", "x2", "w", "idx", "eidx", "we", "thr", "consts", "models", "valid", "med",
            "pre", "thr2", "cand", "out_model", "out_err", "out_inl", "out_best")
    ] + [(name, _L) for name in ("idx_sb", "eidx_sb", "we_sb", "thr_sb")] + [
        ("sigma_c", ctypes.c_float),
    ] + [(name, ctypes.c_int) for name in ("B", "N", "H", "S", "P", "F")]


# robust_fit's 2.5 * 1.4826 (the LMedS 2.5-sigma cut), as PyTorch
# multiplies by it: in float32.
SIGMA_C = float(np.float32(2.5 * 1.4826))


def _launch(x1, x2, w, threshold, params, num_hypotheses: int, idx, dense, generator):
    """Launch the RANSAC's four kernels; returns every buffer they write, by
    name: the candidates (``models``, ``valid``), the finalists (``cand``),
    the adapted squared cut (``thr2``), the winner (``model``, ``best``), its
    inliers over all points (``inliers``) and its errors times them
    (``err``)."""
    lead = x1.shape[:-2]
    n = x1.shape[-2]
    bsz = math.prod(lead)
    dev = x1.device
    if idx is None:  # robust_fit's own draws
        if dense:
            idx = robust.draw_dense(generator, lead, n, num_hypotheses, 5, dev)
        else:
            idx = robust.sample_indices(generator, n, num_hypotheses, 5, w=w)
    idx = robust.as_indices(idx.to(dev), w).to(torch.int64)
    h = idx.shape[-2]
    if idx.shape[-1] != 5:
        raise ValueError(f"multiview_ransac: needs (H, 5) draws, got {tuple(idx.shape)}")
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
    if not (p_cap < s and f_cap < h * MODELS):
        raise ValueError(
            f"multiview_ransac: the prescore needs more than {p_cap} eval points and more "
            f"than {f_cap} candidates, got {s} and {h * MODELS}")
    if not isinstance(threshold, torch.Tensor):
        raise TypeError("multiview_ransac: the threshold must be a tensor on the points' device")
    f32 = torch.float32

    def rows(x, tail, dtype, name, dense_axes=1):
        return build.batch_rows("multiview_ransac", x, lead, tail, dtype, name, dense_axes)

    x1, x2, w = (_packed(x, lead, tail, name)
                 for x, tail, name in ((x1, (n, 2), "x1"), (x2, (n, 2), "x2"), (w, (n,), "w")))
    idx = rows(idx, (h, 5), torch.int64, "idx", 2)
    eidx = rows(eidx, (s,), torch.int64, "eidx")
    we = rows(we, (s,), f32, "we")
    thr = threshold.to(dev, f32).reshape(-1)
    if thr.numel() not in (1, bsz):
        raise ValueError(f"multiview_ransac: {thr.numel()} thresholds for {bsz} streams")
    for t in (x2, w, idx, eidx, we):
        if t.device != dev:
            raise ValueError(f"multiview_ransac: tensors on {t.device} and {dev}")
    hm = h * MODELS
    out = {
        "models": torch.empty((bsz, hm, 3, 3), dtype=f32, device=dev),
        "valid": torch.empty((bsz, hm), dtype=torch.int32, device=dev),
        "med": torch.empty((bsz, hm), dtype=f32, device=dev),
        "pre": torch.empty((bsz, hm), dtype=torch.int32, device=dev),
        "thr2": torch.empty((bsz,), dtype=f32, device=dev),
        "cand": torch.empty((bsz, f_cap), dtype=torch.int64, device=dev),
        "model": torch.empty((bsz, 3, 3), dtype=f32, device=dev),
        "err": torch.empty((bsz, n), dtype=f32, device=dev),
        "inliers": torch.empty((bsz, n), dtype=f32, device=dev),
        "best": torch.empty((bsz,), dtype=torch.int64, device=dev),
    }
    tables = _tables(str(dev))
    args = _Args(
        *(t.data_ptr() for t in (x1, x2, w, idx, eidx, we, thr, tables)),
        *(out[k].data_ptr() for k in ("models", "valid", "med", "pre", "thr2", "cand", "model",
                                      "err", "inliers", "best")),
        idx.stride(0), eidx.stride(0), we.stride(0), 0 if thr.numel() == 1 else thr.stride(0),
        SIGMA_C, bsz, n, h, s, p_cap, f_cap,
    )
    lib = build.library()
    with build.on_device(dev):
        status = lib.ofps_multiview_ransac(ctypes.byref(args), build.stream_ptr(dev))
    build.check(status, "ofps_multiview_ransac")
    ransac.launches += 4
    return out


def eight_point_essential(x1, x2, w) -> torch.Tensor:
    """:func:`_eight_point_essential` of packed (B, N, 2) CUDA points and
    (B, N) weights: ``ops/epipolar``'s sums over the points by PyTorch
    (the weight, the centroids, the mean distances, the normal matrix), the
    elementwise steps between them in two launches (the distances; the
    Hartley transforms with the weighted rows' outer products), then the
    inverse iteration, the rank-2 SVD, the denormalization and the
    projection onto E in one."""
    bsz, n = w.shape
    dev = w.device
    f32 = torch.float32
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    c1 = torch.sum(x1 * w[..., None], dim=-2) / wsum[..., None]
    c2 = torch.sum(x2 * w[..., None], dim=-2) / wsum[..., None]
    d1, d2 = (torch.empty((bsz, n), dtype=f32, device=dev) for _ in range(2))
    _points(DISTANCES, bsz, n, dev, a=x1, b=x2, w=w, m=c1, m2=c2, o1=d1, o2=d2)
    mean1 = torch.sum(d1, dim=-1) / wsum
    mean2 = torch.sum(d2, dim=-1) / wsum
    t1, t2 = (torch.empty((bsz, 3, 3), dtype=f32, device=dev) for _ in range(2))
    terms = torch.empty((bsz, n, 9, 9), dtype=f32, device=dev)
    _points(NORMAL_ROWS, bsz, n, dev, a=x1, b=x2, w=w, m=c1, m2=c2, s1=mean1, s2=mean2,
            o1=t1, o2=t2, o3=terms)
    ata = torch.sum(terms, dim=-3)
    out = torch.empty((bsz, 3, 3), dtype=f32, device=dev)
    lib = build.library()
    with build.on_device(dev):
        status = lib.ofps_multiview_eight_point(
            ata.data_ptr(), t1.data_ptr(), t2.data_ptr(), _tables(str(dev))[_START1:].data_ptr(),
            out.data_ptr(), bsz, build.stream_ptr(dev))
    build.check(status, "ofps_multiview_eight_point")
    ransac.launches += 1
    return out


def ransac(x1, x2, w, threshold, params, num_hypotheses: int,
           idx: Optional[torch.Tensor] = None, dense: bool = False,
           generator: Optional[torch.Generator] = None, plain: bool = False) -> Fit:
    """Multiview's RANSAC over (..., N) correspondences ``x1 -> x2``
    (normalized coordinates) with weights ``w``: the eight-point essential
    refit on the inliers and the RANSAC's result (model after the LO
    rounds, inliers, their count, the winning candidate).

    ``threshold``: the inlier cut in normalized units, a tensor (0-d or
    one per stream); ``params``: the estimator's ``MultiviewParams``;
    ``idx`` (..., H, 5) or (H, 5): the draws, point indices or uniforms
    (else drawn from ``generator``).  CPU tensors, ``plain=True`` and
    parameters the kernels do not cover (:func:`uses_kernels`, decided from
    ``params`` alone) run :func:`ransac_plain`; CUDA tensors launch the
    kernels.
    """
    if not on_kernels(params, x1, plain):
        return ransac_plain(x1, x2, w, threshold, params, num_hypotheses, idx, dense, generator)
    lead, n = x1.shape[:-2], x1.shape[-2]
    bsz = math.prod(lead)
    dev = x1.device
    out = _launch(x1, x2, w, threshold, params, num_hypotheses, idx, dense, generator)
    x1, x2, w = (_packed(x, lead, tail, name)
                 for x, tail, name in ((x1, (n, 2), "x1"), (x2, (n, 2), "x2"), (w, (n,), "w")))
    # robust_fit's LO rounds (binary weights): its sums over the points, of
    # the same tensors, by PyTorch.
    model, inl, cut = out["model"], out["inliers"], out["thr2"]
    err_cur = torch.sum(out["err"], dim=-1)  # the winner's errors times its inliers
    for _ in range(LO_ITERS):
        m2 = eight_point_essential(x1, x2, inl)
        e_inl, inl2, e_inl2 = (torch.empty((bsz, n), dtype=torch.float32, device=dev)
                               for _ in range(3))
        _points(LO_SCORE, bsz, n, dev, a=x1, b=x2, w=w, m=m2, m2=cut, s1=inl, o1=e_inl,
                o2=inl2, o3=e_inl2)
        err_new = torch.sum(e_inl, dim=-1)  # same set: comparable sums
        good = (
            (inl2.sum(-1) >= inl.sum(-1))
            & (err_new < err_cur)
            & torch.isfinite(m2).flatten(-2).all(-1)
        )
        model = torch.where(good[..., None, None], m2, model)
        err_cur = torch.where(good, torch.sum(e_inl2, dim=-1), err_cur)
        inl = torch.where(good[..., None], inl2, inl)
    inliers = (inl > 0.5).to(torch.float32)
    e = eight_point_essential(x1, x2, inliers)
    res = robust.RobustResult(
        model=model.reshape(lead + (3, 3)),
        inliers=inliers.reshape(lead + (n,)),
        score=(inl > 0.5).sum(-1).to(torch.float32).reshape(lead),
        best=out["best"].reshape(lead),
    )
    return Fit(e.reshape(lead + (3, 3)), res)


ransac.launches = 0  # kernel launches (LAUNCHES a call of ransac)
