"""Ground-truth comparison and tracking statistics (port of
``ofps_tpu.apps.gt``, numpy only; the port keeps its own copy).

The ground-truth CSV schema is
``frame,fov_x,fov_y,rot_w,rot_i,rot_j,rot_k,pos_x,pos_y,pos_z``; the
per-frame error is taken against the ground truth's delta rotation, with
the estimate's roll and pitch swapped as in the reference's Blender-sourced
data; averages and the per-estimator statistics CSV follow the reference's
tracking app.  Host-side post-processing of estimator outputs.
"""

from __future__ import annotations

import csv
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class GroundTruthRow:
    frame: int
    fov_x: float
    fov_y: float
    rot: np.ndarray  # (4,) wxyz
    pos: np.ndarray  # (3,)


def load_ground_truth(path: str) -> List[GroundTruthRow]:
    rows = []
    with open(path, newline="") as f:
        for rec in csv.DictReader(f):
            rows.append(
                GroundTruthRow(
                    frame=int(rec["frame"]),
                    fov_x=float(rec["fov_x"]),
                    fov_y=float(rec["fov_y"]),
                    rot=np.array(
                        [
                            float(rec["rot_w"]),
                            float(rec["rot_i"]),
                            float(rec["rot_j"]),
                            float(rec["rot_k"]),
                        ],
                        dtype=np.float64,
                    ),
                    pos=np.array(
                        [float(rec["pos_x"]), float(rec["pos_y"]), float(rec["pos_z"])],
                        dtype=np.float64,
                    ),
                )
            )
    return rows


def write_ground_truth(path: str, rows: Sequence[GroundTruthRow]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(
            "frame fov_x fov_y rot_w rot_i rot_j rot_k pos_x pos_y pos_z".split()
        )
        for r in rows:
            w.writerow(
                [r.frame, r.fov_x, r.fov_y, *r.rot.tolist(), *r.pos.tolist()]
            )


# -- host-side quaternion helpers (numpy mirrors of core.quat) ---------------


def _qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def _qconj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _qangle(q):
    return 2.0 * math.atan2(float(np.linalg.norm(q[1:])), abs(float(q[0])))


def _qeuler(q):
    """nalgebra euler_angles(): (roll, pitch, yaw) of R = Rz Ry Rx."""
    w, x, y, z = q / np.linalg.norm(q)
    roll = math.atan2(2 * (y * z + w * x), 1 - 2 * (x * x + y * y))
    pitch = math.asin(max(-1.0, min(1.0, -2 * (x * z - w * y))))
    yaw = math.atan2(2 * (x * y + w * z), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def rotation_to(q1, q2):
    """nalgebra ``q1.rotation_to(q2)``: r with r * q1 = q2."""
    return _qmul(q2, _qconj(q1))


@dataclasses.dataclass
class TrackingErrorStatistics:
    frame: int
    error: float
    error_r: float
    error_p: float
    error_y: float


@dataclasses.dataclass
class TrackingPoseStatistics:
    delta: float
    delta_r: float
    delta_p: float
    delta_y: float
    r: float
    p: float
    y: float


def calc_err(
    truth: Sequence[GroundTruthRow], transforms: Sequence[np.ndarray]
) -> List[TrackingErrorStatistics]:
    """Per-frame delta-rotation error vs GT.

    ``transforms[i]``: estimated per-frame rotation quaternion of frame i+1
    (the reference indexes ``transforms[t.frame - 1]``).  Euler roll/pitch
    are swapped on the estimate side, matching the Blender-sourced GT quirk.
    """
    out = []
    if not truth:
        return out
    prevs = [truth[0]] + list(truth[:-1])
    for t0, t in zip(prevs, truth):
        i = t.frame - 1
        if i < 0 or i >= len(transforms):
            continue
        rot = np.asarray(transforms[i], dtype=np.float64)
        q = rotation_to(t0.rot, t.rot)
        p, r, y = _qeuler(rot)  # swapped destructure, as the reference
        pt, rt, yt = _qeuler(q)
        err = [abs(r - rt) % math.pi, abs(p - pt) % math.pi, abs(y - yt) % math.pi]
        out.append(
            TrackingErrorStatistics(
                frame=t.frame - 1,
                error=_qangle(rotation_to(rot, q)),
                error_r=err[0],
                error_p=err[1],
                error_y=err[2],
            )
        )
    return out


def calc_avg_err(
    truth: Sequence[GroundTruthRow], transforms: Sequence[np.ndarray]
) -> Tuple[float, float, float, float]:
    """(avg_error, avg_r, avg_p, avg_y) in radians."""
    stats = calc_err(truth, transforms)
    c = max(len(stats), 1)
    return (
        sum(s.error for s in stats) / c,
        sum(s.error_r for s in stats) / c,
        sum(s.error_p for s in stats) / c,
        sum(s.error_y for s in stats) / c,
    )


@dataclasses.dataclass
class TranslationErrorStatistics:
    frame: int
    error_pos: float  # |s * est_pos - gt_pos| (scale-aligned ATE term)
    error_delta: float  # |s * est_delta - gt_delta| per frame
    error_dir: float  # angle between est and gt per-frame deltas (rad)


def align_translation_scale(
    positions: Sequence[np.ndarray], truth: Sequence[GroundTruthRow]
) -> float:
    """Least-squares global scale s minimizing sum |s*est - gt|^2.

    Monocular epipolar translation is observable only up to one global
    scale (the reference's scale chain keeps a CONSISTENT scale via
    ``triangulate_scale``, anchored to an arbitrary first
    step) — so position accuracy is evaluated scale-aligned, the standard
    monocular-VO ATE convention.  Returns 0.0 when no translation was
    estimated at all.
    """
    num = den = 0.0
    for t in truth:
        i = t.frame - 1
        if i < 0 or i >= len(positions):
            continue
        e = np.asarray(positions[i], dtype=np.float64)
        num += float(e @ t.pos)
        den += float(e @ e)
    return num / den if den > 1e-20 else 0.0


def calc_pos_err(
    truth: Sequence[GroundTruthRow],
    positions: Sequence[np.ndarray],
    scale: Optional[float] = None,
) -> Tuple[float, List[TranslationErrorStatistics]]:
    """Scale-aligned position errors vs GT (``pos_x..z``, carried by the
    reference's schema but never scored there).

    ``positions[i]``: estimated accumulated position after frame i+1 (same
    indexing as ``calc_err`` transforms).  Returns ``(ate_rms, stats)``
    where ``ate_rms`` is the RMS scale-aligned absolute trajectory error.
    """
    if scale is None:
        scale = align_translation_scale(positions, truth)
    out: List[TranslationErrorStatistics] = []
    if not truth:
        return 0.0, out
    prevs = [truth[0]] + list(truth[:-1])
    sq_sum = 0.0
    prev_est = np.zeros(3)
    for t0, t in zip(prevs, truth):
        i = t.frame - 1
        if i < 0 or i >= len(positions):
            continue
        est = scale * np.asarray(positions[i], dtype=np.float64)
        gt_delta = t.pos - t0.pos
        est_delta = est - prev_est
        prev_est = est
        e_pos = float(np.linalg.norm(est - t.pos))
        e_delta = float(np.linalg.norm(est_delta - gt_delta))
        ng, ne = np.linalg.norm(gt_delta), np.linalg.norm(est_delta)
        if ng > 1e-9 and ne > 1e-9:
            c = float(np.clip(est_delta @ gt_delta / (ne * ng), -1.0, 1.0))
            e_dir = math.acos(c)
        else:
            e_dir = 0.0
        sq_sum += e_pos * e_pos
        out.append(
            TranslationErrorStatistics(
                frame=t.frame - 1,
                error_pos=e_pos,
                error_delta=e_delta,
                error_dir=e_dir,
            )
        )
    ate = math.sqrt(sq_sum / max(len(out), 1))
    return ate, out


def pose_stats(
    transforms: Sequence[np.ndarray], poses: Sequence[np.ndarray]
) -> List[TrackingPoseStatistics]:
    """Per-frame delta + accumulated euler stats."""
    out = []
    for rot, pose in zip(transforms, poses):
        rot = np.asarray(rot, dtype=np.float64)
        pose = np.asarray(pose, dtype=np.float64)
        p, r, y = _qeuler(pose)
        dp, dr, dy = _qeuler(rot)
        out.append(
            TrackingPoseStatistics(
                delta=_qangle(rot), delta_r=dr, delta_p=dp, delta_y=dy, r=r, p=p, y=y
            )
        )
    return out


def write_stats_csv(
    path: str,
    err: Sequence[TrackingErrorStatistics],
    pose: Sequence[TrackingPoseStatistics],
) -> None:
    """Per-estimator stats CSV (the reference tracking app's export layout)."""
    err_by_frame = {s.frame: s for s in err}
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(
            "frame delta delta_r delta_p delta_y r p y"
            " error error_r error_p error_y".split()
        )
        for i, ps in enumerate(pose):
            es = err_by_frame.get(i)
            w.writerow(
                [
                    i,
                    f"{ps.delta:.6f}",
                    f"{ps.delta_r:.6f}",
                    f"{ps.delta_p:.6f}",
                    f"{ps.delta_y:.6f}",
                    f"{ps.r:.6f}",
                    f"{ps.p:.6f}",
                    f"{ps.y:.6f}",
                ]
                + (
                    [
                        f"{es.error:.6f}",
                        f"{es.error_r:.6f}",
                        f"{es.error_p:.6f}",
                        f"{es.error_y:.6f}",
                    ]
                    if es
                    else ["", "", "", ""]
                )
            )
