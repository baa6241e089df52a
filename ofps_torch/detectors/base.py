"""Detector protocol and registry (port of ``ofps_tpu.detectors.base``).

``detect(flow: SparseFlow, props=None)`` and the optional dense fast path
``detect_field(field (..., gh, gw, 2), props=None)`` return a fixed-shape
:class:`DetectionResult` batched over the leading dims.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

_REGISTRY: Dict[str, Callable[..., "DetectorInstance"]] = {}
_BUILTIN = ("block_motion",)


class DetectionResult(NamedTuple):
    """Fixed-shape equivalent of ``Option<(area, MotionField)>``."""

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


def _load_builtin_detectors() -> None:
    from ofps_torch.core.plugins import load_external_plugins

    for mod in _BUILTIN:
        importlib.import_module(f"ofps_torch.detectors.{mod}")
    load_external_plugins()


def available_detectors():
    _load_builtin_detectors()
    return sorted(_REGISTRY)


def create_detector(name: str, **kwargs) -> DetectorInstance:
    _load_builtin_detectors()
    if name not in _REGISTRY:
        raise KeyError(f"unknown detector {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
