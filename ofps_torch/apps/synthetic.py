"""Synthetic camera-rotation ground truth: a grid of 3-D points seen from
two camera views, and the flow field between them.

The reference's in-code estimator fixture (each of its estimator crates
carries a copy): screen points unprojected to 3-D through the identity
view, projected through an identity and a rotated ``look_at_rh`` view, the
difference being the flow.  The evaluation matrix
(:mod:`ofps_torch.apps.evaluate_matrix`) draws its exact "gt-mv" fields and
its translation paths from here.  Host-side numpy and CPU tensors; only the
returned :class:`SparseFlow` goes to ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ofps_torch.core import quat
from ofps_torch.core.camera import look_at_rh
from ofps_torch.core.motion import SparseFlow


def calc_view(rot_q, pos, forward=(0.0, -1.0, 0.0)) -> torch.Tensor:
    """``look_at_rh(pos, pos + rot*fwd, rot*up)`` (4, 4), the fixture's
    view of a camera at ``pos`` rotated by ``rot_q`` (homography and libmv
    fixtures look along ``forward=(0, 1, 0)``)."""
    rot_q = torch.as_tensor(np.asarray(rot_q), dtype=torch.float32)
    pos = torch.as_tensor(np.asarray(pos), dtype=torch.float32)
    fwd = quat.rotate_vec(rot_q, torch.tensor(forward, dtype=torch.float32))
    up = quat.rotate_vec(rot_q, torch.tensor([0.0, 0.0, 1.0]))
    return look_at_rh(pos, pos + fwd, up)


def get_grid(nx: int, ny: int, camera, skip_edges: bool = False) -> torch.Tensor:
    """(n, 3) screen-point grid unprojected to 3-D.  Like the reference's
    fixture, it hands the identity *view* (not its inverse) to
    ``unproject``, whose argument is an inverse view."""
    start = 1 if skip_edges else 0
    pts = np.array(
        [[x / nx, y / ny] for x in range(start, nx) for y in range(start, ny)],
        dtype=np.float32,
    )
    view = calc_view(quat.identity(), torch.zeros(3))
    return camera.unproject(torch.from_numpy(pts), view)


def synthetic_field(camera, rot_q, grid=None, capacity=None, center_filter: bool = True,
                    forward=(0.0, -1.0, 0.0), device="cuda") -> SparseFlow:
    """Flow field between the identity view and the view rotated by
    ``rot_q``, as a :class:`SparseFlow` of ``capacity`` entries (default:
    the grid's size) on ``device``.  ``center_filter`` keeps the points
    within 0.71 of the screen centre in either view."""
    if grid is None:
        grid = get_grid(50, 50, camera)
    v1 = calc_view(quat.identity(), torch.zeros(3), forward)
    v2 = calc_view(rot_q, torch.zeros(3), forward)
    p1 = camera.project(grid, v1).numpy()
    p2 = camera.project(grid, v2).numpy()
    if center_filter:
        mid = np.array([0.5, 0.5], dtype=np.float32)
        keep = (np.linalg.norm(p1 - mid, axis=-1) <= 0.71) | (
            np.linalg.norm(p2 - mid, axis=-1) <= 0.71
        )
    else:
        keep = np.ones(len(p1), dtype=bool)
    return SparseFlow.from_arrays(
        p1[keep], (p2 - p1)[keep], capacity=capacity or len(grid), device=device
    )


def euler_deg(roll, pitch, yaw) -> torch.Tensor:
    """Quaternion (4,) of Euler angles in degrees (nalgebra's order)."""
    return quat.from_euler(np.deg2rad(roll), np.deg2rad(pitch), np.deg2rad(yaw))
