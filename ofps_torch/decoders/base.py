"""Decoder protocol and registry (port of ``ofps_tpu.decoders.base``).

Decoders are host-side stateful objects producing numpy arrays, one
:class:`DecodedFrame` per video frame.  The built-in plugins are "mvec"
(the ``.mvec`` replay reader, :mod:`ofps_torch.decoders.mvec`), "av" (codec
motion vectors, :mod:`ofps_torch.decoders.av`) and "cv" (dense flow on the
device, :mod:`ofps_torch.decoders.cv`); modules named in
``OFPS_TORCH_PLUGINS`` may register more (:mod:`ofps_torch.core.plugins`).
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
    """Import the built-in decoders (one that fails to import, e.g. for a
    missing FFmpeg, is skipped) and the external plugin modules."""
    import importlib

    from ofps_torch.core.plugins import load_external_plugins

    for mod in ("mvec", "av", "cv"):
        try:
            importlib.import_module(f"ofps_torch.decoders.{mod}")
        except ImportError:
            pass
    load_external_plugins()


def create_decoder(input_path: str, plugin: Optional[str] = None, **kwargs) -> Decoder:
    """The decoder named ``plugin`` over ``input_path``: with no plugin
    named, the "mvec" replay reader for a ``.mvec`` path and "av" for any
    other."""
    _load_builtin_decoders()
    if plugin is None:
        plugin = "mvec" if input_path.endswith(".mvec") else "av"
    if plugin not in _REGISTRY:
        raise KeyError(f"unknown decoder {plugin!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[plugin](input_path, **kwargs)


def available_decoders():
    _load_builtin_decoders()
    return sorted(_REGISTRY)
