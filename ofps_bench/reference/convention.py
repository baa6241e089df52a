# Frozen copy of the port's plain ``ofps_torch/estimators/convention.py`` (the benchmark's
# reference; it imports nothing of the port).
"""Axis-convention remap between solver output and the codebase convention
(port of ``ofps_tpu.estimators.convention``).

The quaternion-exact form of the reference's (roll, pitch, yaw) ->
(-roll, -yaw, pitch) euler swap is conjugation by a -90 deg rotation about
x followed by inversion, which maps components (w, x, y, z) ->
(w, -x, -z, y) for all angles.
"""

from __future__ import annotations

import torch


def remap_solver_rotation(q: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) -> (w, -x, -z, y): the homography/libmv axis remap."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([w, -x, -z, y], dim=-1)
