# Trimmed frozen copy of the port's ``ofps_torch/estimators/base.py``: the
# estimator record, its registry and the cached intrinsics.  The registry
# finds an estimator by its name: ``ofps_bench/reference/<name>.py``
# registers itself when imported.  ``families`` is the benchmark's own hook.
"""Estimator record and registry of the reference."""

from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ofps_bench.reference.solve import inv3x3

_REGISTRY: Dict[str, Callable[..., "EstimatorInstance"]] = {}


@functools.lru_cache(maxsize=16)
def camera_intrinsics(camera, device: str):
    """(K, K^-1) of ``camera`` on ``device``."""
    k = camera.intrinsics().to(device)
    return k, inv3x3(k)


@dataclasses.dataclass
class EstimatorInstance:
    name: str
    params: Any
    init: Callable[[], Any]
    estimate: Callable[..., Tuple[torch.Tensor, torch.Tensor, Any]]
    dyn_defaults: Callable[[], dict] = dataclasses.field(
        default_factory=lambda: (lambda: {})
    )
    draw: Optional[Callable[..., Any]] = None
    # (flow, camera, props, dense, fit_idx) -> (..., F, 4): every rotation
    # the estimator may return where rounding picks among them (the check
    # takes the nearest); None where it returns one.
    families: Optional[Callable[..., torch.Tensor]] = None


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory

    return deco


def resolve(registry: Dict[str, Callable], kind: str, name: str) -> Callable:
    """The factory registered as ``name``, importing
    ``ofps_bench.reference.<name>`` first, which registers it."""
    module = f"ofps_bench.reference.{name}"
    if name not in registry:
        try:
            importlib.import_module(module)
        except ModuleNotFoundError as e:
            if e.name != module:
                raise
    if name not in registry:
        raise KeyError(f"no reference {kind} {name!r}: module {module} does not register it; "
                       f"registered: {sorted(registry)}")
    return registry[name]


def create_estimator(name: str, **kwargs) -> EstimatorInstance:
    return resolve(_REGISTRY, "estimator", name)(**kwargs)
