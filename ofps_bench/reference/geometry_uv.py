# Frozen copy of the port's plain ``ofps_torch/ops/geometry_uv.py`` (the benchmark's
# reference; it imports nothing of the port).
"""Plane-layout screen-space rotation geometry (port of
``ofps_tpu.ops.geometry_uv``).

Point sets travel as u/v *planes* of shape ``(..., N)``; quaternions are
4-tuples of planes ``(w, x, y, z)`` and rotation matrices 9-tuples in
row-major order.  Tuples of planes broadcast like any tensors, so hypothesis
and stream batches are just leading dims.  The camera constants are float32
scalars folded in as Python numbers (exact: every float32 is a double).
"""

from __future__ import annotations

import functools

import torch

from ofps_bench.reference.camera import ROTATE_VIEW


def rv_chain(camera):
    """``(m1, m2)``: ``ROTATE_VIEW @ inv_proj`` and ``proj @ ROTATE_VIEW``."""
    rv = torch.as_tensor(ROTATE_VIEW)
    return rv @ camera.inv_proj(), camera.proj() @ rv


@functools.lru_cache(maxsize=None)
def _chain_scalars(camera):
    """Row coefficients of :func:`rv_chain` as Python floats, with the
    homogeneous ``z + w`` fold of the unproject side summed in float32."""
    m1, m2 = rv_chain(camera)
    a = [
        (m1[i, 0], m1[i, 1], m1[i, 2] + m1[i, 3]) for i in range(4)
    ]
    return (
        [[float(x) for x in row] for row in a],
        [[float(x) for x in m2[i]] for i in range(4)],
    )


def rotate_planes(camera, px, py, r):
    """Rotate screen points around the camera; planes in, planes out.

    Exact plane transcription of ``StandardCamera.rotate`` (unproject ->
    rotate -> project, including the NDC z-divide)."""
    a, g = _chain_scalars(camera)
    nx = px * 2.0 - 1.0
    ny = py * 2.0 - 1.0
    h0, h1, h2, hw = (row[0] * nx + row[1] * ny + row[2] for row in a)
    inv = 1.0 / hw
    wx, wy, wz = h0 * inv, h1 * inv, h2 * inv
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = r
    vx = r00 * wx + r01 * wy + r02 * wz
    vy = r10 * wx + r11 * wy + r12 * wz
    vz = r20 * wx + r21 * wy + r22 * wz
    g0, g1, g2, gw = (
        row[0] * vx + row[1] * vy + row[2] * vz + row[3] for row in g
    )
    ginv = 1.0 / gw
    n0, n1, n2 = g0 * ginv, g1 * ginv, g2 * ginv
    sx = n0 / n2
    sy = n1 / n2
    return (sx + 1.0) * 0.5, (sy + 1.0) * 0.5


def delta_planes(camera, px, py, r):
    """Screen displacement planes under rotation ``r`` (camera.delta)."""
    qx, qy = rotate_planes(camera, px, py, r)
    return qx - px, qy - py


def point_angle_planes(camera, px, py):
    """Per-axis angular position planes (StandardCamera.point_angle)."""
    fx, fy = camera.point_angle_focals()
    return torch.atan((px - 0.5) / float(fx)), torch.atan((py - 0.5) / float(fy))


# -- quaternion planes -------------------------------------------------------


def qident_like(plane):
    o = torch.ones_like(plane)
    z = torch.zeros_like(plane)
    return (o, z, z, z)


def qmul(a, b):
    """Hamilton product on (w, x, y, z) plane tuples (quat.mul)."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    )


def qconj(q):
    w, x, y, z = q
    return (w, -x, -y, -z)


def qmat(q):
    """Rotation-matrix 9-tuple from a unit-quaternion plane tuple."""
    w, x, y, z = q
    return (
        1.0 - 2.0 * (y * y + z * z),
        2.0 * (x * y - w * z),
        2.0 * (x * z + w * y),
        2.0 * (x * y + w * z),
        1.0 - 2.0 * (x * x + z * z),
        2.0 * (y * z - w * x),
        2.0 * (x * z - w * y),
        2.0 * (y * z + w * x),
        1.0 - 2.0 * (x * x + y * y),
    )


def solve3_planes(a, b, fallback: float = 0.0):
    """Cramer solve of symmetric 3x3 systems given as plane tuples.

    ``a`` = (a11, a12, a13, a22, a23, a33), ``b`` = (b1, b2, b3); a singular
    system (|det| <= 1e-30) returns ``fallback``."""
    a11, a12, a13, a22, a23, a33 = a
    b1, b2, b3 = b
    c11 = a22 * a33 - a23 * a23
    c12 = a13 * a23 - a12 * a33
    c13 = a12 * a23 - a13 * a22
    d = a11 * c11 + a12 * c12 + a13 * c13
    safe = torch.abs(d) > 1e-30
    dinv = 1.0 / torch.where(safe, d, torch.ones_like(d))
    c22 = a11 * a33 - a13 * a13
    c23 = a12 * a13 - a11 * a23
    c33 = a11 * a22 - a12 * a12
    x1 = (b1 * c11 + b2 * c12 + b3 * c13) * dinv
    x2 = (b1 * c12 + b2 * c22 + b3 * c23) * dinv
    x3 = (b1 * c13 + b2 * c23 + b3 * c33) * dinv
    fb = torch.full_like(d, fallback)
    return (
        torch.where(safe, x1, fb),
        torch.where(safe, x2, fb),
        torch.where(safe, x3, fb),
    )
