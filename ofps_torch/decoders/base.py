"""Decoder protocol and registry (port of ``ofps_tpu.decoders.base``).

Decoders are host-side stateful objects producing numpy arrays, one
:class:`DecodedFrame` per video frame.  The built-in plugins are "av" (codec
motion vectors, :mod:`ofps_torch.decoders.av`) and "cv" (dense flow on the
device, :mod:`ofps_torch.decoders.cv`).  The JAX package's ".mvec" replay
reader and external plugin modules are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Protocol, Tuple

import numpy as np

_REGISTRY: Dict[str, Callable[..., "Decoder"]] = {}


@dataclasses.dataclass
class DecodedFrame:
    """One frame's worth of decoder output.

    ``pos``/``motion``: (N, 2) float32, [0,1]-normalized.  ``has_mvs`` is
    False when the frame carries no motion (the first frame of a stream).
    ``frame``: optional (H, W, 4) uint8 RGBA image.
    """

    pos: np.ndarray
    motion: np.ndarray
    has_mvs: bool = True
    frame: Optional[np.ndarray] = None


class Decoder(Protocol):
    def process_frame(
        self, want_frame: bool = False, skip: int = 0
    ) -> Optional[DecodedFrame]:
        """Decode the next frame; ``None`` at end of stream.  ``skip``
        drops that many frames first."""
        ...

    def get_framerate(self) -> Optional[float]:
        ...

    def get_aspect(self) -> Optional[Tuple[int, int]]:
        ...


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory

    return deco


def _load_builtin_decoders() -> None:
    import importlib

    for mod in ("av", "cv"):
        importlib.import_module(f"ofps_torch.decoders.{mod}")


def create_decoder(input_path: str, plugin: Optional[str] = None, **kwargs) -> Decoder:
    """The decoder named ``plugin`` (default "av") over ``input_path``."""
    _load_builtin_decoders()
    plugin = plugin or "av"
    if plugin not in _REGISTRY:
        raise KeyError(f"unknown decoder {plugin!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[plugin](input_path, **kwargs)


def available_decoders():
    _load_builtin_decoders()
    return sorted(_REGISTRY)
