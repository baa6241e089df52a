# Trimmed frozen copy of the port's ``ofps_torch/estimators/base.py``: the
# estimator record, its registry and the cached intrinsics.
"""Estimator record and registry of the reference."""

from __future__ import annotations

import dataclasses
import functools
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


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory

    return deco


def create_estimator(name: str, **kwargs) -> EstimatorInstance:
    from ofps_bench.reference import almeida, homography  # noqa: F401  (registers)

    return _REGISTRY[name](**kwargs)
