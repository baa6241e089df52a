"""Middlebury ``.flo`` optical-flow file I/O (port of
``ofps_tpu.decoders.flo``): magic float ``202021.25`` ("PIEH"),
little-endian ``i32`` width and height, then row-major interleaved
``(u, v)`` float32 pairs, as OpenCV's ``writeOpticalFlow`` writes them.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 202021.25


def write_flo(path: str, flow: np.ndarray) -> None:
    """Write an (H, W, 2) float32 flow field."""
    flow = np.asarray(flow, dtype="<f4")
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(struct.pack("<fii", MAGIC, w, h))
        f.write(flow.tobytes())


def read_flo(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic, w, h = struct.unpack("<fii", f.read(12))
        if abs(magic - MAGIC) > 1e-3:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        data = np.frombuffer(f.read(w * h * 8), dtype="<f4")
    return data.reshape(h, w, 2).copy()
