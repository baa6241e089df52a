"""Carry configuration and stream state across from the JAX package.

The system has no learned weights: what crosses is the configuration
(flow, estimator and detector parameters) and the carried stream state.
These functions only read fields (``._asdict()``, ``np.asarray``) of the
objects handed to them; they import neither ``jax`` nor ``ofps_tpu``.
"""

from __future__ import annotations

import numpy as np
import torch

from ofps_torch.detectors.block_motion import BlockMotionParams
from ofps_torch.estimators.almeida import AlmeidaParams
from ofps_torch.estimators.homography import HomographyParams
from ofps_torch.estimators.libmv import LibmvParams, PrevMotion
from ofps_torch.estimators.multiview import MultiviewParams
from ofps_torch.ops.flow_lk import LKParams
from ofps_torch.ops.flow_pyramid import FlowParams, FrameCache
from ofps_torch.parallel.stream import StreamState

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def flow_params_from_jax(p) -> FlowParams:
    """Port ``FlowParams`` from ``ofps_tpu``'s; the TPU-only fields
    (``fused``, ``interpret``, ``flow_dtype``) are dropped."""
    d = p._asdict()
    kept = {k: d[k] for k in FlowParams._fields if k in d}
    kept["cost_dtype"] = _DTYPES[np.dtype(d["cost_dtype"]).name]
    return FlowParams(**kept)


def lk_params_from_jax(p) -> LKParams:
    return LKParams(**p._asdict())


def almeida_params_from_jax(p) -> AlmeidaParams:
    return AlmeidaParams(**p._asdict())


def homography_params_from_jax(p) -> HomographyParams:
    return HomographyParams(**p._asdict())


def multiview_params_from_jax(p) -> MultiviewParams:
    return MultiviewParams(**p._asdict())


def libmv_params_from_jax(p) -> LibmvParams:
    return LibmvParams(**p._asdict())


def block_motion_params_from_jax(p) -> BlockMotionParams:
    return BlockMotionParams(**p._asdict())


def _t(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def _carry_from_jax(carry, device):
    """An estimator's carry: ``()``, or libmv's ``PrevMotion`` (any named
    tuple with its fields, read as numpy arrays)."""
    if carry == ():
        return ()
    if getattr(carry, "_fields", None) == PrevMotion._fields:
        return PrevMotion(*(_t(getattr(carry, f), device) for f in PrevMotion._fields))
    raise ValueError(f"unknown estimator carry {type(carry).__name__}")


def state_from_jax(state, device) -> StreamState:
    """Port a JAX ``StreamState`` (fields read as numpy arrays).  The
    estimators' carries must be stateless (``()``) or libmv's
    ``PrevMotion``."""
    return StreamState(
        prev_cache=FrameCache(pyr=tuple(_t(x, device) for x in state.prev_cache.pyr)),
        warm_uv=tuple(_t(x, device) for x in state.warm_uv),
        has_prev=_t(state.has_prev, device),
        rot=tuple(_t(x, device) for x in state.rot),
        pos=tuple(_t(x, device) for x in state.pos),
        est=tuple(_carry_from_jax(e, device) for e in state.est),
    )


def state_to_numpy(state: StreamState) -> dict:
    """The port's state as a dict of numpy arrays (tuples kept; an
    estimator carry as a dict of its fields, ``{}`` when stateless)."""

    def n(x):
        return x.detach().cpu().numpy()

    return {
        "pyr": tuple(n(x) for x in state.prev_cache.pyr),
        "warm_uv": tuple(n(x) for x in state.warm_uv),
        "has_prev": n(state.has_prev),
        "rot": tuple(n(x) for x in state.rot),
        "pos": tuple(n(x) for x in state.pos),
        "est": tuple({f: n(getattr(e, f)) for f in getattr(e, "_fields", ())}
                     for e in state.est),
    }
