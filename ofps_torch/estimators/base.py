"""Estimator protocol, registry and pose integration (port of
``ofps_tpu.estimators.base``).

An :class:`EstimatorInstance` carries static ``params``, ``init()`` (the
carried state; stateless estimators use ``()``) and
``estimate(state, flow, camera, generator=None, props=None, dense=False,
fit_idx=None, move_magnitude=None) -> (quat (B, 4), translation (B, 3),
state)`` over a batch of
B sparse flows.  An estimator that samples may also provide ``draw``: its
random inputs drawn ahead of ``estimate`` (passed back as ``fit_idx``), so
that ``estimate`` itself is a fixed sequence of device operations, dense
or masked.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ofps_torch.core import quat
from ofps_torch.ops.solve import inv3x3

_REGISTRY: Dict[str, Callable[..., "EstimatorInstance"]] = {}
_BUILTIN = ("almeida", "homography", "multiview", "libmv")


@functools.lru_cache(maxsize=16)
def camera_intrinsics(camera, device: str):
    """(K, K^-1) of ``camera`` on ``device``, built once (outside any CUDA
    graph: the capture's eager warm-up call fills the cache)."""
    k = camera.intrinsics().to(device)
    return k, inv3x3(k)


@dataclasses.dataclass
class EstimatorInstance:
    """A configured estimator: functions over tensors + static params."""

    name: str
    params: Any
    init: Callable[[], Any]
    estimate: Callable[..., Tuple[torch.Tensor, torch.Tensor, Any]]
    # Continuous-valued properties that may change between frames.
    dyn_defaults: Callable[[], dict] = dataclasses.field(
        default_factory=lambda: (lambda: {})
    )
    # (generator, lead_shape, n_points, device, dense=True) -> fit_idx for
    # ``estimate``: a tensor, or a tuple of tensors.  Dense draws are point
    # indices; masked ones (dense=False) are uniforms that ``estimate`` maps
    # to the valid points of its flow (``ops.robust.as_indices``).
    draw: Optional[Callable[..., Any]] = None

    def motion_step(self, state, flow, camera, rot, pos, generator=None,
                    move_magnitude=None, props=None, dense=False, fit_idx=None):
        """Estimate and integrate: ``pos += rot * tr; rot = r * rot``.
        Returns (rot, pos, state).  ``move_magnitude`` is the optional
        translation-magnitude hint (None: unhinted); only libmv uses it.
        ``fit_idx``: the estimator's draws in place of drawing them from
        ``generator``.  Both are passed on only when given."""
        extra = {k: v for k, v in (("move_magnitude", move_magnitude), ("fit_idx", fit_idx))
                 if v is not None}
        r, tr, state = self.estimate(
            state, flow, camera, generator, props=props, dense=dense, **extra
        )
        return quat.mul(r, rot), pos + quat.rotate_vec(rot, tr), state


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory

    return deco


def _load_builtin_estimators() -> None:
    from ofps_torch.core.plugins import load_external_plugins

    for mod in _BUILTIN:
        importlib.import_module(f"ofps_torch.estimators.{mod}")
    load_external_plugins()


def available_estimators():
    _load_builtin_estimators()
    return sorted(_REGISTRY)


def create_estimator(name: str, **kwargs) -> EstimatorInstance:
    _load_builtin_estimators()
    if name not in _REGISTRY:
        raise KeyError(f"unknown estimator {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
