# Frozen copy of the port's plain ``ofps_torch/ops/robust.py`` (the benchmark's
# reference; it imports nothing of the port).
"""Batched robust model fitting, RANSAC / LMedS (port of
``ofps_tpu.ops.robust``).

Hypotheses are a batch dim: minimal-sample gathers, fits, error
evaluation over a shared point subset and scoring run as whole-tensor
operations over ``(*lead, H, ...)``, with leading stream dims ``lead``;
data-dependent inlier sets are fixed-shape 0/1 weights.  No operation
synchronises with the host, so a fit can be captured in a CUDA graph.

torch cannot reproduce ``jax.random``: the samplers draw from a
``torch.Generator``, and parity tests inject the JAX package's draws
(``idx``).  ``dense_eval_indices`` is the JAX package's numpy code, so the
eval subsets agree exactly.

``minimal_fit(x1s, x2s, ws) -> (models (*lead, H, M, 3, 3), valid
(*lead, H, M))`` takes the (*lead, H, k, 2) samples; ``error_fn(models,
x1, x2)`` broadcasts models (..., 3, 3) against points (..., N, 2) over
their leading dims; ``refit_fn(x1, x2, w) -> (*lead, 3, 3)``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


def ransac_budget(
    desired_confidence: float,
    outlier_frac: float,
    sample_size: int,
    max_hypotheses: int,
    min_hypotheses: int = 8,
) -> int:
    """Hypothesis count N = log(1 - p) / log(1 - (1 - eps)^k), clipped to
    [min_hypotheses, max_hypotheses]; a static number that sizes the batch."""
    p_good = max(1e-9, (1.0 - outlier_frac) ** sample_size)
    denom = math.log(max(1e-12, 1.0 - p_good))
    n = math.log(max(1e-12, 1.0 - desired_confidence)) / denom
    return int(min(max_hypotheses, max(min_hypotheses, math.ceil(n))))


def uniform_cap_weights(mask: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Keep every (total/num_samples)-th valid point of ``mask`` (..., N)."""
    c = torch.cumsum(mask, dim=-1)
    stride = torch.clamp(c[..., -1:] / num_samples, min=1.0)
    crosses = torch.floor(c / stride) > torch.floor((c - 1.0) / stride)
    return mask * crosses


def dense_eval_indices(n: int, cap: int):
    """Static (eidx, we) for the eval-cap subset of an ALL-VALID point set.

    Replays ``uniform_cap_weights`` + :func:`eval_subset`'s cumulative-count
    compaction in numpy with the same f32 stride arithmetic.
    """
    c = np.arange(1, n + 1, dtype=np.float32)
    stride = np.maximum(np.float32(c[-1] / np.float32(cap)), np.float32(1.0))
    crosses = np.floor(c / stride) > np.floor((c - np.float32(1.0)) / stride)
    cw = np.cumsum(crosses.astype(np.int32))
    eidx = np.minimum(
        np.searchsorted(cw, np.arange(1, cap + 1, dtype=np.int32), side="left"),
        n - 1,
    ).astype(np.int32)
    we = np.where(
        np.arange(cap) < cw[-1], crosses[eidx].astype(np.float32), 0.0
    ).astype(np.float32)
    return eidx, we


@functools.lru_cache(maxsize=16)
def dense_eval_subset(n: int, cap: int, device: str):
    """Device (eidx (S,), we (S,)) of the eval subset of an all-valid set
    of n points, S = min(cap, n); built once per device (the copy to the
    card happens outside any CUDA graph: the first, eager call makes it)."""
    if cap < n:
        eidx, we = dense_eval_indices(n, cap)
        return torch.from_numpy(eidx).to(device, torch.int64), torch.from_numpy(we).to(device)
    return torch.arange(n, device=device), torch.ones(n, device=device)


@functools.lru_cache(maxsize=16)
def _arange(n: int, device: str) -> torch.Tensor:
    return torch.arange(n, device=device)


def eval_subset(w: torch.Tensor, cap: int):
    """(eidx, we), each (..., cap): the spatially uniform subset of at most
    ``cap`` valid points of ``w`` (..., N), compacted to the front in raster
    order (``uniform_cap_weights``, then the r-th selected point is
    ``searchsorted(cumsum(selected), r + 1)``).  Past-the-end slots clamp to
    the last index with weight 0."""
    n = w.shape[-1]
    wc = uniform_cap_weights(w, cap)
    cw = torch.cumsum((wc > 0.5).to(torch.int64), dim=-1)
    ar = _arange(cap, str(w.device))
    queries = (ar + 1).expand(w.shape[:-1] + (cap,)).contiguous()
    eidx = torch.clamp(torch.searchsorted(cw, queries), max=n - 1)
    we = torch.where(ar < cw[..., -1:], torch.gather(wc, -1, eidx), 0.0)
    return eidx, we


class RobustResult(NamedTuple):
    model: torch.Tensor  # (..., 3, 3)
    inliers: torch.Tensor  # (..., N) float 0/1 (subset of the input weights)
    score: torch.Tensor  # (...,) inlier count (RANSAC) or -median error (LMedS)
    best: torch.Tensor  # (...,) index of the winning candidate model (< H*M)


def sample_indices(
    generator: Optional[torch.Generator], n: int, rows: int, k: int,
    device="cpu", w: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Uniform draws of valid point indices.

    ``w`` None: (rows, k) draws from [0, n) of an all-valid point set,
    truncating ``u * n`` as the JAX package's ``dense=True`` sampler does.
    ``w`` (..., N): (..., rows, k) draws of valid points (w > 0.5), mapped
    from uniforms by :func:`indices_from_uniform` (the masked sampler).
    Independent draws may repeat an index within a row (a repeated point
    is a degenerate minimal fit that loses the vote).  ``generator`` must
    live on the points' device (None: torch's default generator).
    """
    if w is None:
        u = torch.rand((rows, k), generator=generator, device=device)
        return torch.clamp((u * n).to(torch.int64), max=n - 1)
    u = torch.rand(w.shape[:-1] + (rows, k), generator=generator, device=w.device)
    return indices_from_uniform(u, w)


def indices_from_uniform(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Valid point indices (..., rows, k) of uniforms ``u`` (..., rows, k)
    over the valid points (w > 0.5) of ``w`` (..., N): the r-th valid point,
    r = floor(u * m) of the m valid ones, found as ``searchsorted(cumsum(
    valid), r + 1)`` (the JAX package's masked sampler).  With no valid
    point the index clamps to N - 1, as a JAX gather clamps it.  A fixed
    sequence of device operations, so the uniforms can be drawn ahead and
    the mapping captured in a CUDA graph with a mask that depends on the
    data."""
    valid = (w > 0.5).to(torch.int64)
    m = torch.clamp(valid.sum(-1, keepdim=True), min=1)  # (..., 1)
    c = torch.cumsum(valid, dim=-1)
    shape = u.shape
    u = u.reshape(shape[:-2] + (-1,))
    r = torch.minimum((u * m).to(torch.int64), m - 1)
    idx = torch.clamp(torch.searchsorted(c, r + 1), max=w.shape[-1] - 1)
    return idx.reshape(shape)


def draw_dense(generator, lead, n: int, rows: int, k: int, device) -> torch.Tensor:
    """(*lead, rows, k) dense draws over n all-valid points, one
    ``sample_indices`` call for all streams (stream-major)."""
    idx = sample_indices(generator, n, rows * math.prod(lead), k, device=device)
    return idx.reshape(tuple(lead) + (rows, k))


def draw(generator, lead, n: int, rows: int, k: int, device, dense: bool = True):
    """An estimator's RANSAC draws made ahead of its fit: dense indices
    (``draw_dense``), or for a masked flow (``dense=False``) the (*lead,
    rows, k) uniforms that :func:`indices_from_uniform` maps to valid
    points inside the fit, where the mask is known."""
    if dense:
        return draw_dense(generator, lead, n, rows, k, device)
    return torch.rand(tuple(lead) + (rows, k), generator=generator, device=device)


def as_indices(draws: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Point indices of ``draws`` (..., rows, k): integer draws are
    indices already; float draws are uniforms, mapped to the valid points
    of ``w`` (..., N) by :func:`indices_from_uniform`."""
    if draws.is_floating_point():
        return indices_from_uniform(draws, w)
    return draws


def masked_median(err: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Median over the valid (w > 0.5) entries of the last dim; rows with
    no valid entry give 1e30.  ``w`` broadcasts against ``err``.

    The JAX package's radix select, bit for bit: ``max(err, 0)`` as uint32
    bit patterns (NaNs keep their bits, negatives and -0 become +0), the
    k-th smallest pattern (k = (nvalid - 1) // 2) built from bit 30 down in
    31 rounds of compare and count.  PyTorch has no full uint32 arithmetic,
    so the patterns are compared as int64: a NaN with its sign bit set then
    orders above every candidate, as in uint32.
    """
    valid = w > 0.5
    nvalid = valid.sum(-1)
    kp1 = torch.clamp(nvalid - 1, min=0) // 2 + 1
    bits = err.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    negative = (bits >= 0x80000000) & ((bits & 0x7FFFFFFF) <= 0x7F800000)
    u = torch.where(negative, 0, bits)
    u = torch.where(valid, u, 1 << 32)  # never below a candidate
    p = torch.zeros(u.shape[:-1], dtype=torch.int64, device=err.device)
    for i in range(31):
        t = p | (1 << (30 - i))
        cnt = (u < t[..., None]).sum(-1)
        # Fewer than k + 1 entries below t: the median has this bit.
        p = torch.where(cnt < kp1, t, p)
    med = p.to(torch.int32).view(torch.float32)
    return torch.where(nvalid > 0, med, 1e30)


def _take_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (*lead, N, C) at idx (*lead, *shape) along N: (*lead, *shape, C)."""
    lead = x.shape[:-2]
    flat = idx.reshape(lead + (-1, 1)).expand(lead + (-1, x.shape[-1]))
    return torch.gather(x, -2, flat).reshape(idx.shape + (x.shape[-1],))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (*lead, M, ...) at idx (*lead, F) along M: (*lead, F, ...)."""
    nlead = idx.dim() - 1
    tail = x.shape[nlead + 1:]
    flat = idx.reshape(idx.shape + (1,) * len(tail)).expand(idx.shape + tail)
    return torch.gather(x, nlead, flat)


def robust_fit(
    x1: torch.Tensor,
    x2: torch.Tensor,
    w: torch.Tensor,
    *,
    minimal_fit: Callable,
    sample_size: int,
    error_fn: Callable,
    num_hypotheses: int,
    threshold,
    use_lmeds: bool = False,
    eval_cap: int = 0,
    adaptive_threshold: bool = False,
    refit_fn: Optional[Callable] = None,
    lo_iters: int = 2,
    refit_weight: str = "binary",
    prescore_cap: int = 0,
    finalists: int = 32,
    dense: bool = False,
    idx: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> RobustResult:
    """RANSAC or LMedS over (*lead, N) correspondences ``x1 -> x2`` with
    weights ``w``; the JAX package's ``robust_fit`` over a batch of point
    sets.

    ``idx`` (*lead, H, k): the hypotheses' minimal-sample draws, point
    indices or uniforms (:func:`as_indices`); else drawn from ``generator``:
    the dense sampler when ``dense``, the masked one otherwise.  ``eval_cap``: hypotheses are scored on a spatially uniform
    subset of at most that many valid points (static when ``dense``); the
    winner's inlier set is recomputed over all points.  ``prescore_cap``:
    every candidate is first scored on a strided ``prescore_cap``-point
    subsample of the eval subset and only the ``finalists`` best go on (ties
    keep the lower index first, as ``jax.lax.top_k``).
    ``adaptive_threshold`` (RANSAC): raise the cut to the LMedS 2.5-sigma
    cut of the best hypothesis's median error when that is larger.
    ``refit_fn``: LO-RANSAC, ``lo_iters`` rounds of a refit on the inliers
    (binary or Cauchy ``cut / (cut + err)`` weights), each kept only if the
    inlier set does not shrink, the error over the current inliers strictly
    drops and the model is finite.
    """
    n = x1.shape[-2]
    lead = x1.shape[:-2]
    dev = x1.device
    if idx is None:
        if dense:
            idx = draw_dense(generator, lead, n, num_hypotheses, sample_size, dev)
        else:
            idx = sample_indices(generator, n, num_hypotheses, sample_size, w=w)
    idx = as_indices(idx.to(dev), w).to(torch.int64).expand(lead + idx.shape[-2:])

    models, valid = minimal_fit(
        _take_points(x1, idx), _take_points(x2, idx),
        _take_points(w[..., None], idx)[..., 0],
    )  # (*lead, H, M, 3, 3), (*lead, H, M)
    hm = models.shape[-4] * models.shape[-3]
    models = models.reshape(lead + (hm, 3, 3))
    # A non-finite candidate is not valid: its NaN median would make the
    # LMedS statistic, and with it the adaptive cut, NaN (no inliers at
    # all).  The JAX package lacks this gate; its 7-point cubic gives NaN
    # roots where the leading coefficient rounds to 0.
    valid = valid.reshape(lead + (hm,)) & torch.isfinite(models).flatten(-2).all(-1)

    if eval_cap and eval_cap < n:
        if dense:
            eidx, we = dense_eval_subset(n, eval_cap, str(dev))
            eidx = eidx.expand(lead + eidx.shape)
            we = we.expand(lead + we.shape)
        else:
            eidx, we = eval_subset(w, eval_cap)
        x1e, x2e = _take_points(x1, eidx), _take_points(x2, eidx)
    else:
        x1e, x2e, we = x1, x2, w

    def errors(m, a, b):  # models (*lead, F, 3, 3) on points (*lead, S, 2)
        return error_fn(m, a[..., None, :, :], b[..., None, :, :])

    if isinstance(threshold, torch.Tensor):  # per stream, on the points' device
        t = threshold.to(torch.float32)
        thr2 = torch.broadcast_to(t * t, lead)
    else:
        t = np.float32(threshold)
        thr2 = torch.full(lead, float(t * t), dtype=torch.float32, device=dev)
    nvalid = torch.clamp(torch.sum(we, dim=-1), min=sample_size + 1.0)
    sigma_k = 2.5 * 1.4826 * (1.0 + 5.0 / (nvalid - sample_size))
    adaptive_pending = adaptive_threshold

    def raise_to_lmeds_cut(thr2, med, valid):
        # The LMedS statistic (the least median over valid hypotheses) and
        # its 2.5-sigma cut bound the inlier band an accurate model needs.
        med_best = torch.min(torch.where(valid, med, 1e30), dim=-1).values
        return torch.maximum(thr2, torch.square(sigma_k) * torch.clamp(med_best, min=0.0))

    cand = None
    if prescore_cap and finalists < hm and prescore_cap < x1e.shape[-2]:
        # Progressive round 1 on a strided (still spatially uniform)
        # subsample of the eval subset.
        stride = x1e.shape[-2] // prescore_cap
        pidx = _arange(prescore_cap, str(dev)) * stride
        x1p, x2p, wp = x1e[..., pidx, :], x2e[..., pidx, :], we[..., pidx]
        errs_p = errors(models, x1p, x2p)  # (*lead, HM, P)
        if use_lmeds:
            pre = -torch.where(valid, masked_median(errs_p, wp[..., None, :]), 1e30)
        else:
            if adaptive_threshold:
                thr2 = raise_to_lmeds_cut(thr2, masked_median(errs_p, wp[..., None, :]), valid)
                adaptive_pending = False
            ok = (errs_p <= thr2[..., None, None]) & (wp > 0.5)[..., None, :]
            pre = torch.where(valid, ok.sum(-1), -1).to(torch.float32)
        # jax.lax.top_k order: descending, the lower index first among ties.
        cand = torch.sort(pre, dim=-1, descending=True, stable=True).indices[..., :finalists]
        models = _take(models, cand)
        valid = _take(valid, cand)

    errs = errors(models, x1e, x2e)  # (*lead, F, S)

    if use_lmeds:
        med = masked_median(errs, we[..., None, :])
        score = -torch.where(valid, med, 1e30)
        best = torch.argmax(score, dim=-1)  # first maximum
        best_score = _take(score, best[..., None])[..., 0]
        sigma = sigma_k * torch.sqrt(torch.clamp(-best_score, min=0.0))
        cut = torch.maximum(sigma * sigma, thr2)
    else:
        if adaptive_pending:
            thr2 = raise_to_lmeds_cut(thr2, masked_median(errs, we[..., None, :]), valid)
        ok = (errs <= thr2[..., None, None]) & (we > 0.5)[..., None, :]
        score = torch.where(valid, ok.sum(-1), -1)
        best = torch.argmax(score, dim=-1)  # first maximum
        cut = thr2
    model = _take(models, best[..., None])[..., 0, :, :]
    best_err = error_fn(model, x1, x2)  # (*lead, N)
    inliers = (best_err <= cut[..., None]) & (w > 0.5)
    final_score = best_score if use_lmeds else inliers.sum(-1)

    if refit_fn is not None:
        inl = inliers.to(torch.float32)
        err_pt = best_err
        err_cur = torch.sum(best_err * inl, dim=-1)
        cutw = torch.clamp(cut, min=1e-30)[..., None]
        for _ in range(max(1, lo_iters)):
            wfit = inl * (cutw / (cutw + err_pt)) if refit_weight == "cauchy" else inl
            m2 = refit_fn(x1, x2, wfit)
            err2 = error_fn(m2, x1, x2)
            inl2 = ((err2 <= cut[..., None]) & (w > 0.5)).to(torch.float32)
            err_new = torch.sum(err2 * inl, dim=-1)  # same set: comparable sums
            good = (
                (inl2.sum(-1) >= inl.sum(-1))
                & (err_new < err_cur)
                & torch.isfinite(m2).flatten(-2).all(-1)
            )
            model = torch.where(good[..., None, None], m2, model)
            err_cur = torch.where(good, torch.sum(err2 * inl2, dim=-1), err_cur)
            err_pt = torch.where(good[..., None], err2, err_pt)
            inl = torch.where(good[..., None], inl2, inl)
        inliers = inl > 0.5
        if not use_lmeds:
            final_score = inliers.sum(-1)

    if cand is not None:
        best = _take(cand, best[..., None])[..., 0]
    return RobustResult(
        model=model,
        inliers=inliers.to(torch.float32),
        score=final_score.to(torch.float32),
        best=best,
    )
