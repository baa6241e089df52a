""".mvec motion-vector interchange format (port of
``ofps_tpu.decoders.mvec``).

Per frame a little-endian ``u32`` count followed by ``count`` records of
four LE ``f32`` values ``(pos.x, pos.y, motion.x, motion.y)``.  The file
doubles as the decoder-free replay fixture of the tests and of
``chip_smoke.py``.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Optional, Tuple

import numpy as np

from ofps_torch.decoders.base import DecodedFrame, register
from ofps_torch.decoders.io_utils import open_stream


def write_mvec_frame(f: BinaryIO, pos: np.ndarray, motion: np.ndarray) -> None:
    pos = np.asarray(pos, dtype="<f4").reshape(-1, 2)
    motion = np.asarray(motion, dtype="<f4").reshape(-1, 2)
    if pos.shape != motion.shape:
        raise ValueError(f"pos {pos.shape} and motion {motion.shape} differ")
    f.write(struct.pack("<I", pos.shape[0]))
    f.write(np.concatenate([pos, motion], axis=1).astype("<f4").tobytes())


def read_mvec_frame(f: BinaryIO) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(pos (N, 2), motion (N, 2)) of the next frame; None at the end of
    the stream or on a truncated frame."""
    hdr = f.read(4)
    if len(hdr) < 4:
        return None
    (count,) = struct.unpack("<I", hdr)
    payload = f.read(count * 16)
    if len(payload) < count * 16:
        return None
    rec = np.frombuffer(payload, dtype="<f4").reshape(count, 4)
    return rec[:, :2].copy(), rec[:, 2:].copy()


@register("mvec")
class MvecDecoder:
    """Replay decoder for ``.mvec`` dumps (and ``tcp://`` byte streams)."""

    def __init__(self, input_path: str):
        self._f = open_stream(input_path)

    def process_frame(self, want_frame: bool = False, skip: int = 0):
        rec = None
        for _ in range(skip + 1):
            rec = read_mvec_frame(self._f)
            if rec is None:
                return None
        pos, motion = rec
        return DecodedFrame(pos=pos, motion=motion, has_mvs=True, frame=None)

    def get_framerate(self):
        return None

    def get_aspect(self):
        return None

    def close(self):
        self._f.close()
