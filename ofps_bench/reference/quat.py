# Frozen copy of the port's plain ``ofps_torch/core/quat.py`` (the benchmark's
# reference; it imports nothing of the port).
"""Quaternion and rotation utilities (port of ``ofps_tpu.core.quat``).

Quaternions are ``(..., 4)`` float32 tensors in ``(w, x, y, z)`` order with
nalgebra's conventions; everything broadcasts over leading batch dims.
"""

from __future__ import annotations

import torch


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    # Built on the device (no host-to-device copy, so CUDA graphs capture it).
    return (torch.arange(4, device=device) == 0).to(dtype)


def normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=1e-30)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``a * b`` (apply ``b`` first, then ``a``)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def inverse(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a *unit* quaternion."""
    return conj(q)


def from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(torch.sum(axis * axis, dim=-1, keepdim=True))
    axis = axis / torch.clamp(n, min=1e-30)
    half = torch.as_tensor(angle)[..., None] * 0.5
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def from_euler(roll, pitch, yaw) -> torch.Tensor:
    """nalgebra ``from_euler_angles``: ``Rz(yaw) * Ry(pitch) * Rx(roll)``."""
    roll, pitch, yaw = (
        torch.as_tensor(x, dtype=torch.float32) for x in (roll, pitch, yaw)
    )
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ],
        dim=-1,
    )


def to_euler(q: torch.Tensor):
    """Return ``(roll, pitch, yaw)`` matching nalgebra ``euler_angles()``."""
    w, x, y, z = q.unbind(-1)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    r10 = 2.0 * (x * y + w * z)
    r00 = 1.0 - 2.0 * (y * y + z * z)
    return (
        torch.atan2(r21, r22),
        torch.asin(torch.clamp(-r20, -1.0, 1.0)),
        torch.atan2(r10, r00),
    )


def to_matrix3(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix, shape ``(..., 3, 3)``."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1.0 - 2.0 * (y * y + z * z),
            2.0 * (x * y - w * z),
            2.0 * (x * z + w * y),
            2.0 * (x * y + w * z),
            1.0 - 2.0 * (x * x + z * z),
            2.0 * (y * z - w * x),
            2.0 * (x * z - w * y),
            2.0 * (y * z + w * x),
            1.0 - 2.0 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def to_matrix4(q: torch.Tensor) -> torch.Tensor:
    """Homogeneous rotation matrix, shape ``(..., 4, 4)``."""
    r3 = to_matrix3(q)
    m = torch.zeros(r3.shape[:-2] + (4, 4), dtype=r3.dtype, device=r3.device)
    m[..., :3, :3] = r3
    m[..., 3, 3] = 1.0
    return m


def from_matrix3(r: torch.Tensor) -> torch.Tensor:
    """Unit quaternion from a rotation matrix (..., 3, 3): branchless
    Shepperd (the strongest of four constructions, first maximum), sign
    canonicalized to w >= 0."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22
    cases = torch.stack(
        [
            torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1),
        ],
        dim=-2,
    )  # (..., 4 cases, 4)
    mags = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(mags, dim=-1)  # first maximum
    q = torch.gather(cases, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = normalize(q)
    return torch.where(q[..., :1] < 0, -q, q)


def rotate_vec(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate a 3-vector by a unit quaternion."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + w * t + torch.linalg.cross(qv, t)


def angle(q: torch.Tensor) -> torch.Tensor:
    """Rotation angle in radians of a unit quaternion."""
    return 2.0 * torch.atan2(
        torch.linalg.vector_norm(q[..., 1:], dim=-1), torch.abs(q[..., 0])
    )


def angle_to(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Angle between two rotations (nalgebra ``angle_to``)."""
    return angle(mul(inverse(a), b))


def axis_angle(q: torch.Tensor):
    """(axis, angle); the axis is +x for near-identity rotations and is
    negated when w < 0 (nalgebra keeps the represented angle positive)."""
    v = q[..., 1:]
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    sign = torch.where(q[..., :1] < 0, -1.0, 1.0)
    x_axis = (torch.arange(3, device=q.device) == 0).to(q.dtype)
    axis = torch.where(n > 1e-12, sign * v / torch.clamp(n, min=1e-30), x_axis)
    return axis, angle(q)
