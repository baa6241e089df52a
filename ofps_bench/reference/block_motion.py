# Frozen copy of the port's plain ``ofps_torch/detectors/block_motion.py`` (the benchmark's
# reference; it imports nothing of the port).
"""Block-subdivision motion detector (port of
``ofps_tpu.detectors.block_motion``): densify the motion into a coarse
grid, threshold per-cell mean motion magnitude, keep the largest
8-connected island, report it when it covers at least ``min_size``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ofps_bench.reference.motion import F32_EPS, Densifier, SparseFlow
from ofps_bench.reference.det_base import DetectionResult, DetectorInstance, register
from ofps_bench.reference.components import largest_component


class BlockMotionParams(NamedTuple):
    min_size: float = 0.05
    subdivide: int = 3
    target_motion: float = 0.003


def block_dim(params: BlockMotionParams) -> int:
    """Grid side length: ceil(1 / (sqrt(min_size) / subdivide))."""
    return math.ceil(1.0 / (math.sqrt(params.min_size) / params.subdivide))


def _detect_from_cells(params, field: torch.Tensor, target_motion) -> DetectionResult:
    """Threshold + largest island on the (..., dim, dim, 2) cell means."""
    dim = block_dim(params)
    if target_motion is None:
        target_motion = params.target_motion
    moving = torch.linalg.vector_norm(field, dim=-1) >= target_motion
    mask, area = largest_component(moving)
    detected = (area.to(torch.float32) / float(dim * dim)) >= params.min_size
    island = torch.where(mask[..., None], field, torch.zeros_like(field))
    return DetectionResult(detected=detected, area=area, field=island, mask=mask)


def detect_motion(params: BlockMotionParams, flow: SparseFlow,
                  target_motion=None) -> DetectionResult:
    dim = block_dim(params)
    dens = Densifier.zeros(dim, dim, flow.mask.shape[:-1], flow.mask.device)
    return _detect_from_cells(params, dens.add_flow(flow).finalize(), target_motion)


def _axis_cell_matrix_np(src: int, dst: int):
    """(src, dst) one-hot lattice-row -> detector-cell map, in f32 like
    ``flow_cell_index`` on the ``field_to_sparse`` positions (j / src)."""
    pos = (np.arange(src, dtype=np.float32) / np.float32(src)).astype(np.float32)
    c = np.floor(pos * np.float32(dst - 1) + np.float32(0.5)).astype(np.int64)
    m = np.zeros((src, dst), np.float32)
    m[np.arange(src), np.clip(c, 0, dst - 1)] = 1.0
    return m


@functools.lru_cache(maxsize=16)
def _cell_matrices(gh: int, gw: int, dim: int, device: str):
    sy = torch.from_numpy(_axis_cell_matrix_np(gh, dim)).to(device)
    sx = torch.from_numpy(_axis_cell_matrix_np(gw, dim)).to(device)
    counts = sy.sum(dim=0)[:, None] * sx.sum(dim=0)[None, :] + F32_EPS
    return sy, sx, counts


def detect_motion_field(params: BlockMotionParams, field: torch.Tensor,
                        target_motion=None) -> DetectionResult:
    """Dense fast path on a regular-lattice (..., gh, gw, 2) field: the same
    result as ``detect_motion(params, field_to_sparse(field))`` with the
    densify as two static one-hot matmuls."""
    dim = block_dim(params)
    gh, gw = field.shape[-3], field.shape[-2]
    sy, sx, counts = _cell_matrices(gh, gw, dim, str(field.device))
    sums = torch.einsum("hg,...hwc,wk->...gkc", sy, field, sx)
    return _detect_from_cells(params, sums / counts[..., None], target_motion)


@register("block_motion")
def make_block_motion(**kwargs) -> DetectorInstance:
    params = BlockMotionParams(**kwargs)
    return DetectorInstance(
        name="block_motion",
        params=params,
        detect=lambda flow, props=None: detect_motion(
            params, flow, (props or {}).get("target_motion")
        ),
        dyn_defaults=lambda: {"target_motion": params.target_motion},
        detect_field=lambda field, props=None: detect_motion_field(
            params, field, (props or {}).get("target_motion")
        ),
    )
