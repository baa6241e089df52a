"""Almeida's rotation solve: the iterative least squares
(:func:`solve_ypr_planes`), the RANSAC's plain version
(:func:`ransac_plain`, the CPU path) and the RANSAC in three launches of
the kernels of ``csrc/almeida_ransac.cu`` (:func:`ransac`).

The kernels take the flow's planes, the hypotheses' point indices and the
eval subset as they are (gathers included), fit the hypotheses, score
them, and pick the winner and refit on its inliers.  The squared inlier
angle is a device pointer when it is a tensor (a prop of the consumers'
graph), so a new value is a copy into the graph's input, not a new graph.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ofps_torch.core import quat
from ofps_torch.core.motion import SparseFlow
from ofps_torch.kernels import build
from ofps_torch.ops.geometry_uv import (
    delta_planes,
    point_angle_planes,
    qconj,
    qident_like,
    qmat,
    qmul,
    solve3_planes,
)

EPS = 0.001 * math.pi / 180.0
ALPHA = 0.5
LSQ_ITERS = math.ceil(15.0 / ALPHA)  # 30


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


def solve_ypr_planes(camera, px, py, mu, mv, w, dim: int):
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
    for i in range(LSQ_ITERS):
        alpha = 1.0 if i == LSQ_ITERS - 1 else ALPHA
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


def _take(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """plane (..., N) gathered at idx (..., *shape) along the point axis."""
    lead = plane.shape[:-1]
    idx = idx.expand(lead + idx.shape[-2:]) if idx.dim() == 2 else idx
    flat = idx.reshape(lead + (-1,))
    return torch.gather(plane, -1, flat).reshape(idx.shape)


def ransac_plain(camera, flow: SparseFlow, fit_idx: torch.Tensor, eidx: torch.Tensor,
                 w_e: torch.Tensor, bound):
    """The plain version of :func:`ransac`: the hypotheses ``fit_idx``
    (point indices, (H, 3) or (..., H, 3)) fitted and scored on the eval
    subset ``eidx`` / ``w_e`` (..., S) against the squared inlier angle
    ``bound``, then the refit on the first maximum's inliers.  Returns
    ``(rot (..., 4), best (...), best_count (...))``."""
    pos, motion, mask = flow
    dev = pos.device

    def fit_plane(plane):  # (..., N) -> (..., 3, H)
        return _take(plane, fit_idx).transpose(-1, -2)

    fits = solve_ypr_planes(
        camera,
        fit_plane(pos[..., 0]), fit_plane(pos[..., 1]),
        fit_plane(motion[..., 0]), fit_plane(motion[..., 1]),
        fit_plane(mask), dim=-2,
    )  # (w, x, y, z) planes, each (..., H)

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
    inliers = (err2 <= bound) & (w_e[..., None, :] > 0.5)  # (..., H, S)
    counts = inliers.sum(dim=-1)
    best = torch.argmax(counts, dim=-1, keepdim=True)  # first maximum
    best_count = torch.gather(counts, -1, best)
    best_w = torch.gather(
        inliers, -2, best[..., None].expand(best.shape + (inliers.shape[-1],))
    ).squeeze(-2).to(torch.float32)
    refit = torch.stack(
        solve_ypr_planes(camera, pxe, pye, mue, mve, best_w, dim=-1), dim=-1
    )
    rot = torch.where(best_count >= 3, refit, quat.identity(device=dev))
    return rot, best[..., 0], best_count[..., 0]


_P = ctypes.c_void_p
_L = ctypes.c_int64


class _Args(ctypes.Structure):
    """``Args`` of ``csrc/almeida_ransac.cu``, field for field."""

    _fields_ = [
        (name, _P) for name in ("pos", "motion", "mask", "fit_idx", "eidx", "we", "bound",
                                "fits", "counts", "work", "out_q", "out_best")
    ] + [
        (name, _L) for name in ("pos_sb", "pos_sn", "mot_sb", "mot_sn", "mask_sb", "mask_sn",
                                "fit_sb", "eidx_sb", "we_sb", "bound_sb")
    ] + [
        ("consts", ctypes.c_float * 58),
        ("bound_value", ctypes.c_float),
        ("alpha", ctypes.c_float),
    ] + [(name, ctypes.c_int) for name in ("B", "H", "S", "iters")]


TERMS = 14  # the refit's scratch floats per eval point (kTerms)


@functools.lru_cache(maxsize=16)
def _consts(camera) -> tuple:
    """The kernel's ``Consts`` for ``camera``: the unproject and project
    rows of ``ops/geometry_uv._chain_scalars``, the three EPS rotations,
    and the float32 reciprocals of EPS and of the point-angle focals (on
    the card PyTorch divides by a host scalar as a multiply by its float32
    reciprocal)."""
    from ofps_torch.ops.geometry_uv import _chain_scalars

    a, g = _chain_scalars(camera)
    fx, fy = camera.point_angle_focals()
    one = np.float32(1.0)
    return tuple(
        [x for row in a for x in row]
        + [x for row in g for x in row]
        + [x for m in _proto_mats() for x in m]
        + [float(one / np.float32(EPS)), float(one / np.float32(float(fx))),
           float(one / np.float32(float(fy)))]
    )


def ransac(camera, flow, fit_idx: torch.Tensor, eidx: torch.Tensor, w_e: torch.Tensor,
           bound, plain: bool = False):
    """Almeida's RANSAC over (..., N) flows: returns ``(rot (..., 4), best
    (...), best_count (...))``, the refit camera rotation (identity under 3
    inliers), the winning hypothesis (the first maximum) and its inliers.

    ``fit_idx`` (..., H, 3) or (H, 3): the hypotheses' point indices;
    ``eidx``, ``w_e`` (..., S): the eval subset's indices and weights;
    ``bound``: the squared inlier angle, a number, a 0-d tensor or one per
    stream.  CPU tensors, and ``plain=True``, run :func:`ransac_plain`; CUDA
    tensors launch the three kernels (``best``, ``best_count`` int32 then).
    """
    pos, motion, mask = flow
    if plain or not build.on_cuda("almeida_ransac", pos):
        return ransac_plain(camera, flow, fit_idx, eidx, w_e, bound)
    lead = pos.shape[:-2]
    n, h, s = pos.shape[-2], fit_idx.shape[-2], eidx.shape[-1]
    bsz = math.prod(lead)
    if h < 1 or s < 1 or fit_idx.shape[-1] != 3:
        raise ValueError(f"almeida_ransac: needs (H, 3) draws and S >= 1, got "
                         f"{tuple(fit_idx.shape)} and S = {s}")
    dev = pos.device
    for t in (motion, mask, fit_idx, eidx, w_e):
        if t.device != dev:
            raise ValueError(f"almeida_ransac: tensors on {t.device} and {dev}")
    f32 = torch.float32

    def _rows(x, tail, dtype, name, dense=1):
        return build.batch_rows("almeida_ransac", x, lead, tail, dtype, name, dense)

    pos = _rows(pos, (n, 2), f32, "pos")
    motion = _rows(motion, (n, 2), f32, "motion")
    mask = _rows(mask, (n,), f32, "mask", dense=0)
    fit_idx = _rows(fit_idx, (h, 3), torch.int64, "fit_idx", dense=2)
    eidx = _rows(eidx, (s,), torch.int64, "eidx")
    w_e = _rows(w_e, (s,), f32, "w_e")
    bound_t, bound_value, bound_sb = None, 0.0, 0
    if isinstance(bound, torch.Tensor):
        bound_t = bound.to(dev, f32).reshape(-1)
        if bound_t.numel() not in (1, bsz):
            raise ValueError(f"almeida_ransac: {bound_t.numel()} bounds for {bsz} streams")
        bound_sb = 0 if bound_t.numel() == 1 else bound_t.stride(0)
    else:
        bound_value = float(bound)

    fits = torch.empty((bsz, h, 4), dtype=f32, device=dev)
    counts = torch.empty((bsz, h), dtype=torch.int32, device=dev)
    work = torch.empty((bsz, TERMS, s), dtype=f32, device=dev)
    out_q = torch.empty((bsz, 4), dtype=f32, device=dev)
    out_best = torch.empty((bsz, 2), dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = _Args(
        ptr(pos), ptr(motion), ptr(mask), ptr(fit_idx), ptr(eidx), ptr(w_e), ptr(bound_t),
        ptr(fits), ptr(counts), ptr(work), ptr(out_q), ptr(out_best),
        pos.stride(0), pos.stride(1), motion.stride(0), motion.stride(1),
        mask.stride(0), mask.stride(1), fit_idx.stride(0), eidx.stride(0), w_e.stride(0),
        bound_sb, (ctypes.c_float * 58)(*_consts(camera)), bound_value, ALPHA,
        bsz, h, s, LSQ_ITERS,
    )
    lib = build.library()
    with build.on_device(dev):
        status = lib.ofps_almeida_ransac(ctypes.byref(args), build.stream_ptr(dev))
    build.check(status, "ofps_almeida_ransac")
    ransac.launches += 3
    return (out_q.reshape(lead + (4,)), out_best[:, 0].reshape(lead),
            out_best[:, 1].reshape(lead))


ransac.launches = 0  # kernel launches (three a call)
