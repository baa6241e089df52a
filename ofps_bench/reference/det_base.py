# Trimmed frozen copy of the port's ``ofps_torch/detectors/base.py``.  The
# registry finds a detector by its name: ``ofps_bench/reference/<name>.py``
# registers itself when imported.
"""Detector record and registry of the reference."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from ofps_bench.reference.est_base import resolve

_REGISTRY: Dict[str, Callable[..., "DetectorInstance"]] = {}


class DetectionResult(NamedTuple):
    detected: torch.Tensor  # (...) bool
    area: torch.Tensor  # (...) int32 blocks in the motion island
    field: torch.Tensor  # (..., H, W, 2) motion field of the island
    mask: torch.Tensor  # (..., H, W) bool island membership


@dataclasses.dataclass
class DetectorInstance:
    name: str
    params: Any
    detect: Callable[..., DetectionResult]
    dyn_defaults: Callable[[], dict] = lambda: {}
    detect_field: Optional[Callable[..., DetectionResult]] = None


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory

    return deco


def create_detector(name: str, **kwargs) -> DetectorInstance:
    return resolve(_REGISTRY, "detector", name)(**kwargs)
