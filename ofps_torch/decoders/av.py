"""Codec motion-vector decoder ("av"): ctypes bindings over the native
host decoder (port of ``ofps_tpu.decoders.av``).

FFmpeg demux + decode with ``+export_mvs``, surfacing H.264/MPEG motion
vectors as normalized (pos, motion) arrays, and the decoded RGBA frames the
"cv" decoder computes flow from.  The C++ source is the port's own
``ofps_torch/native/avdec.cpp``, compiled with ``g++`` at first use into the
git-ignored ``ofps_torch/_build/`` (keyed by a hash of the source; written
under a temporary name and renamed, so concurrent first uses are safe).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ofps_torch.decoders.base import DecodedFrame, register
from ofps_torch.kernels.build import compile_shared

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "native" / "avdec.cpp"
_BUILD_ROOT = _PKG / "_build"
_CXX_FLAGS = ("-O2", "-fPIC", "-Wall", "-shared")
_LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)

# C entry points: name -> (restype, argtypes).
_SIGNATURES = {
    "ofps_av_open": (_P, [ctypes.c_char_p]),
    "ofps_av_close": (None, [_P]),
    "ofps_av_meta": (_I, [_P, _IP, _IP, ctypes.POINTER(ctypes.c_double)]),
    # ctx, pos, motion, capacity, n_out, rgba, skip
    "ofps_av_next": (_I, [_P, _FP, _FP, _I, _IP, ctypes.c_char_p, _I]),
    # path, w, h, frames, gop, dx, dy, noise, starts, stops, n_events
    "ofps_av_encode_test_events": (_I, [ctypes.c_char_p] + [_I] * 4 + [_F, _F, _I, _IP, _IP, _I]),
    # path, w, h, frames, gop, bit_rate, pixels
    "ofps_av_encode_gray": (_I, [ctypes.c_char_p, _I, _I, _I, _I, ctypes.c_int64, ctypes.c_char_p]),
}


def build() -> Path:
    """Compile the native decoder (if this source hash has no library yet)
    and return the library's path.  Raises on a compiler error."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_CXX_FLAGS + _LIBS).encode())
    lib = _BUILD_ROOT / f"av-{digest.hexdigest()[:16]}" / "libofps_av.so"
    if not lib.exists():
        compile_shared(lib, ["g++", *_CXX_FLAGS, str(_SRC), *_LIBS])
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded native decoder, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def encode_test_video(
    path: str,
    width: int = 320,
    height: int = 240,
    frames: int = 30,
    gop: int = 30,
    dx: float = 2.0,
    dy: float = 0.0,
    pattern: str = "sine",
    move_start: int = 0,
    move_stop: int = 1 << 30,
    events=None,
) -> None:
    """Write a synthetic MPEG-4 clip of a texture translating by (dx, dy)
    px per frame.

    ``pattern``: "sine" (periodic, for codec-MV tests) or "noise"
    (aperiodic value noise, for optical-flow tests, where periodic sines
    alias the block-matching search).  The texture moves only inside
    ``[move_start, move_stop)``, or inside each (start, stop) of ``events``.
    """
    if events is None:
        events = [(move_start, move_stop)]
    n = len(events)
    starts = (ctypes.c_int * n)(*[int(a) for a, _ in events])
    stops = (ctypes.c_int * n)(*[int(b) for _, b in events])
    rc = library().ofps_av_encode_test_events(
        path.encode(), width, height, frames, gop, dx, dy,
        1 if pattern == "noise" else 0, starts, stops, n,
    )
    if rc != 0:
        raise RuntimeError(f"test-clip encoder failed ({rc})")


def encode_gray_video(path: str, frames, gop: int = 30, bit_rate: int = 0) -> None:
    """Encode grayscale frames to an MPEG-4 clip.

    ``frames``: (N, H, W) uint8 (anything array-like is converted).  No
    B-frames, so every inter frame carries forward codec motion vectors:
    rendered or captured content becomes a codec-MV source for the "av"
    decoder.  ``bit_rate`` 0 selects the default (w*h*8 bps).
    """
    arr = np.ascontiguousarray(np.asarray(frames, dtype=np.uint8))
    if arr.ndim != 3:
        raise ValueError(f"frames must be (N, H, W) uint8, got {arr.shape}")
    n, h, w = arr.shape
    rc = library().ofps_av_encode_gray(path.encode(), w, h, n, gop, int(bit_rate), arr.tobytes())
    if rc != 0:
        raise RuntimeError(f"gray-frame encoder failed ({rc})")


@register("av")
class AvDecoder:
    """Decoder over any libavformat input (file path or ``tcp://`` URL;
    ``tcp://@host:port`` listens)."""

    def __init__(self, input_path: str, capacity: int = 65536):
        if input_path.startswith("tcp://@"):
            input_path = "tcp://" + input_path[7:] + "?listen=1"
        self._lib = library()
        self._ctx = self._lib.ofps_av_open(input_path.encode())
        if not self._ctx:
            raise IOError(f"failed to open {input_path!r}")
        w, h, fps = ctypes.c_int(), ctypes.c_int(), ctypes.c_double()
        self._lib.ofps_av_meta(self._ctx, ctypes.byref(w), ctypes.byref(h), ctypes.byref(fps))
        self._size = (w.value, h.value)
        self._fps = fps.value or None
        self._cap = capacity
        self._pos = np.empty((capacity, 2), dtype=np.float32)
        self._mot = np.empty((capacity, 2), dtype=np.float32)

    def process_frame(
        self, want_frame: bool = False, skip: int = 0
    ) -> Optional[DecodedFrame]:
        w, h = self._size
        rgba = np.empty((h, w, 4), dtype=np.uint8) if want_frame else None
        n = ctypes.c_int()
        rc = self._lib.ofps_av_next(
            self._ctx,
            self._pos.ctypes.data_as(_FP),
            self._mot.ctypes.data_as(_FP),
            self._cap,
            ctypes.byref(n),
            rgba.ctypes.data_as(ctypes.c_char_p) if rgba is not None else None,
            skip,
        )
        if rc == -1:
            return None
        if rc < -1:
            raise IOError(f"decode error ({rc})")
        k = n.value
        return DecodedFrame(
            pos=self._pos[:k].copy(),
            motion=self._mot[:k].copy(),
            has_mvs=bool(rc),
            frame=rgba,
        )

    def get_framerate(self) -> Optional[float]:
        return self._fps

    def get_aspect(self) -> Optional[Tuple[int, int]]:
        return self._size

    def close(self):
        if getattr(self, "_ctx", None):
            self._lib.ofps_av_close(self._ctx)
            self._ctx = None

    def __del__(self):
        self.close()
