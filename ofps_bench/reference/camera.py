# Frozen copy of the port's plain ``ofps_torch/core/camera.py`` (the benchmark's
# reference; it imports nothing of the port).
"""Pinhole camera model (port of ``ofps_tpu.core.camera``).

The camera is defined by aspect ratio and vertical field of view; the
principal point is at ``(0.5, 0.5)``.  Screen coordinates live in
``[0, 1]^2``; the projection reproduces the reference exactly, including its
divide of NDC x/y by NDC z after the homogeneous divide.  The 4x4 matrices
are tiny and built in float32 on the CPU; callers move them where needed.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

_ZNEAR = 0.1
_ZFAR = 10.0

# Fixed "Z up, Y forward" view matrix used for screen-space rotations.  It is
# symmetric, orthogonal and involutive, so V == V^T == V^-1.
ROTATE_VIEW = np.array(
    [
        [-1.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, 1.0, 0.0],
        [0.0, 1.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ],
    dtype=np.float32,
)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


class StandardCamera(NamedTuple):
    """Pinhole camera parametrized by aspect ratio and vertical FOV (degrees)."""

    aspect: float
    fov_y_deg: float

    @classmethod
    def create(cls, aspect: float, fov_y_deg: float) -> "StandardCamera":
        return cls(float(np.float32(aspect)), float(np.float32(fov_y_deg)))

    def _focal(self) -> torch.Tensor:
        return 1.0 / torch.tan(torch.deg2rad(_f32(self.fov_y_deg)) * 0.5)

    def proj(self) -> torch.Tensor:
        """OpenGL-style right-handed perspective matrix (float32, CPU)."""
        f = self._focal()
        m = torch.zeros(4, 4, dtype=torch.float32)
        m[0, 0] = f / _f32(self.aspect)
        m[1, 1] = f
        m[2, 2] = -(_ZFAR + _ZNEAR) / (_ZFAR - _ZNEAR)
        m[2, 3] = -2.0 * _ZFAR * _ZNEAR / (_ZFAR - _ZNEAR)
        m[3, 2] = -1.0
        return m

    def inv_proj(self) -> torch.Tensor:
        f = self._focal()
        m22 = _f32(-(_ZFAR + _ZNEAR) / (_ZFAR - _ZNEAR))
        m23 = _f32(-2.0 * _ZFAR * _ZNEAR / (_ZFAR - _ZNEAR))
        m = torch.zeros(4, 4, dtype=torch.float32)
        m[0, 0] = _f32(self.aspect) / f
        m[1, 1] = 1.0 / f
        m[2, 3] = -1.0
        m[3, 2] = 1.0 / m23
        m[3, 3] = m22 / m23
        return m

    def unproject(self, coords: torch.Tensor, inv_view) -> torch.Tensor:
        """Screen-space ``[0,1]^2`` point (..., 2) to a 3D point (..., 3)."""
        ndc = coords * 2.0 - 1.0
        m = (_f32(inv_view) @ self.inv_proj()).to(coords.device)
        p = torch.stack([ndc[..., 0], ndc[..., 1], torch.ones_like(ndc[..., 0])], -1)
        h = p @ m[:3, :3].T + m[:3, 3]
        w = p @ m[3, :3] + m[3, 3]
        return h / w[..., None]

    def project(self, world: torch.Tensor, view) -> torch.Tensor:
        """3D point to screen space, including the NDC x/y by z divide."""
        m = (self.proj() @ _f32(view)).to(world.device)
        h = world @ m[:3, :3].T + m[:3, 3]
        w = world @ m[3, :3] + m[3, 3]
        ndc = h / w[..., None]
        s = ndc[..., :2] / ndc[..., 2:3]
        return (s + 1.0) * 0.5

    def rotate(self, coords: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
        """Rotate screen points around the camera; ``rotation`` is (4, 4)."""
        world = self.unproject(coords, ROTATE_VIEW)
        rot = rotation.to(coords.device)
        world = world @ rot[:3, :3].T + rot[:3, 3]
        return self.project(world, ROTATE_VIEW)

    def delta(self, coords: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
        """Screen-space displacement of points under a camera rotation."""
        return self.rotate(coords, rotation) - coords

    def point_angle_focals(self):
        """``(fx, fy)`` of the intrinsics as float32 scalars."""
        fy = 0.5 / torch.tan(torch.deg2rad(_f32(self.fov_y_deg)) * 0.5)
        return fy / _f32(self.aspect), fy

    def intrinsics(self) -> torch.Tensor:
        """K (3, 3) with principal point (0.5, 0.5) (float32, CPU)."""
        fx, fy = self.point_angle_focals()
        k = torch.zeros(3, 3, dtype=torch.float32)
        k[0, 0], k[0, 2] = fx, 0.5
        k[1, 1], k[1, 2] = fy, 0.5
        k[2, 2] = 1.0
        return k

    def point_angle(self, p: torch.Tensor) -> torch.Tensor:
        """Per-axis angular position of screen points (..., 2), radians."""
        fx, fy = self.point_angle_focals()
        f = torch.stack([fx, fy]).to(p.device)
        return torch.atan((p - 0.5) / f)

    def fov(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Horizontal and vertical field of view in degrees (float32)."""
        ty = torch.tan(torch.deg2rad(_f32(self.fov_y_deg)) * 0.5)
        tx = _f32(self.aspect) * ty
        return torch.rad2deg(torch.atan(tx)) * 2.0, _f32(self.fov_y_deg)

    def essential(self, f: torch.Tensor) -> torch.Tensor:
        """Essential matrix ``K^T F K`` of fundamental matrices (..., 3, 3)."""
        k = self.intrinsics().to(f.device)
        return k.T @ f @ k


def look_at_rh(eye, target, up) -> torch.Tensor:
    """Right-handed look-at view matrices (..., 4, 4) (gluLookAt) from
    ``eye``, ``target`` and ``up`` (..., 3)."""
    eye, target, up = (_f32(x) for x in (eye, target, up))
    fwd = target - eye
    fwd = fwd / torch.linalg.vector_norm(fwd, dim=-1, keepdim=True)
    s = torch.linalg.cross(fwd, up.expand_as(fwd))
    s = s / torch.linalg.vector_norm(s, dim=-1, keepdim=True)
    u = torch.linalg.cross(s, fwd)
    rot = torch.stack([s, u, -fwd], dim=-2)
    trans = -(rot @ eye[..., None])[..., 0]
    m = torch.zeros(rot.shape[:-2] + (4, 4), dtype=torch.float32, device=rot.device)
    m[..., :3, :3] = rot
    m[..., :3, 3] = trans
    m[..., 3, 3] = 1.0
    return m
