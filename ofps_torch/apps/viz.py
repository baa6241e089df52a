"""Host-side visualization (port of ``ofps_tpu.apps.viz``): flow HSV
rendering, overlays, a keyframe panorama, pose plots and a PNG writer.

* :func:`flow_to_rgba` — the detection app's HSV motion overlay (hue from
  atan2(x, y), full saturation and value, alpha = 0.1 + 0.9 |motion|).
* :func:`flow_extract_display` — flow-extract's HSV debug view.
* :func:`keyframe_panorama` — pose-stamped keyframes painted into an
  equirectangular canvas.
* :func:`plot_detection_timeline`, :func:`plot_tracking` — matplotlib
  figures; matplotlib is imported only when a plot is asked for.
* :func:`save_png` — an RGB(A) uint8 PNG from the standard library alone.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Optional, Sequence

import numpy as np
import torch


def _hsva_to_rgba(h, s, v, a):
    """Vectorized HSV(A) -> RGBA uint8; h/s/v/a in [0, 1]."""
    h6 = (h % 1.0) * 6.0
    i = np.floor(h6).astype(np.int32) % 6
    f = h6 - np.floor(h6)
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    rgba = np.stack([r, g, b, a], axis=-1)
    return (np.clip(rgba, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def flow_to_rgba(field: np.ndarray) -> np.ndarray:
    """(H, W, 2) motion field -> (H, W, 4) RGBA overlay."""
    field = np.asarray(field, dtype=np.float32)
    mag = np.linalg.norm(field, axis=-1)
    hue = (np.arctan2(field[..., 0], field[..., 1]) + math.pi) / (2.0 * math.pi)
    alpha = np.where(mag > 0.0, np.minimum(mag * 0.9 + 0.1, 1.0), 0.0)
    return _hsva_to_rgba(hue, np.ones_like(hue), np.ones_like(hue), alpha)


def flow_extract_display(field: np.ndarray, mag_scale: float = 10.0) -> np.ndarray:
    """flow-extract's debug HSV view: hue = direction, value = magnitude."""
    field = np.asarray(field, dtype=np.float32)
    mag = np.linalg.norm(field, axis=-1) * mag_scale
    hue = (np.arctan2(field[..., 1], field[..., 0]) + math.pi) / (2.0 * math.pi)
    val = np.clip(mag, 0.0, 1.0)
    return _hsva_to_rgba(hue, np.ones_like(hue), val, np.ones_like(hue))


def overlay(frame_rgba: np.ndarray, flow_rgba: np.ndarray) -> np.ndarray:
    """Alpha-blend an upscaled flow overlay onto a video frame."""
    h, w = frame_rgba.shape[:2]
    gh, gw = flow_rgba.shape[:2]
    ys = (np.arange(h) * gh // h).clip(0, gh - 1)
    xs = (np.arange(w) * gw // w).clip(0, gw - 1)
    up = flow_rgba[ys][:, xs].astype(np.float32)
    base = frame_rgba[..., :3].astype(np.float32)
    a = up[..., 3:4] / 255.0
    out = base * (1 - a) + up[..., :3] * a
    rgba = np.concatenate([out, np.full((h, w, 1), 255.0, np.float32)], axis=-1)
    return rgba.astype(np.uint8)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgba: np.ndarray) -> bytes:
    """PNG bytes of an (H, W, 3) or (H, W, 4) uint8 image: 8 bits per
    channel, no filtering, one zlib stream."""
    img = np.ascontiguousarray(rgba)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4) uint8, got {img.shape} {img.dtype}")
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def save_png(path: str, rgba: np.ndarray) -> None:
    """Write an (H, W, 3|4) uint8 image as a PNG file."""
    with open(path, "wb") as f:
        f.write(encode_png(np.asarray(rgba)))


def plot_detection_timeline(
    path: str,
    ranges,
    total_frames: int,
    framerate: Optional[float] = None,
    title: Optional[str] = None,
) -> None:
    """Detected-motion timeline bar chart."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 1.8))
    scale = 1.0 / framerate if framerate else 1.0
    for s, e in ranges:
        ax.axvspan(s * scale, (e + 1) * scale, color="#c4443c", alpha=0.8)
    ax.set_xlim(0, total_frames * scale)
    ax.set_yticks([])
    ax.set_xlabel("time (s)" if framerate else "frame")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_tracking(
    path: str,
    pose_stats: Sequence,
    err_stats: Sequence = (),
    title: Optional[str] = None,
) -> None:
    """Rotation-angle + per-frame-delta (+ error) plots as one PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = 3 if err_stats else 2
    fig, axes = plt.subplots(n, 1, figsize=(10, 3 * n), sharex=True)
    frames = np.arange(len(pose_stats))
    deg = 180.0 / math.pi

    axes[0].plot(frames, [s.r * deg for s in pose_stats], label="roll")
    axes[0].plot(frames, [s.p * deg for s in pose_stats], label="pitch")
    axes[0].plot(frames, [s.y * deg for s in pose_stats], label="yaw")
    axes[0].set_ylabel("rotation (deg)")
    axes[0].legend(loc="upper right")

    axes[1].plot(frames, [s.delta * deg for s in pose_stats], label="delta")
    axes[1].set_ylabel("per-frame delta (deg)")
    axes[1].legend(loc="upper right")

    if err_stats:
        ef = [s.frame for s in err_stats]
        axes[2].plot(ef, [s.error * deg for s in err_stats], label="error")
        axes[2].plot(ef, [s.error_y * deg for s in err_stats], label="err yaw")
        axes[2].set_ylabel("error vs GT (deg)")
        axes[2].legend(loc="upper right")

    axes[-1].set_xlabel("frame")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def keyframe_panorama(
    keyframes: Sequence,
    camera,
    width: int = 1024,
    height: int = 512,
) -> np.ndarray:
    """Equirectangular (height, width, 4) RGBA panorama of pose-stamped
    keyframes: each keyframe's image is projected onto the unit sphere
    through its estimated rotation and painted into the canvas, later
    keyframes over earlier ones.

    ``keyframes``: iterable of (frame_idx, rot_wxyz, rgba_image); entries
    whose image is ``None`` are skipped.  ``camera``: StandardCamera.  The
    geometry runs in float32 on the CPU.
    """
    from ofps_torch.core import quat
    from ofps_torch.core.camera import ROTATE_VIEW

    canvas = np.zeros((height, width, 4), np.uint8)

    # World direction per pano pixel (Z up; the identity camera looks along
    # -Y in the projection convention, so lon 0 = -Y puts an identity-pose
    # keyframe at the pano center).
    lon = (np.arange(width) + 0.5) / width * 2.0 * np.pi - np.pi
    lat = np.pi / 2.0 - (np.arange(height) + 0.5) / height * np.pi
    lo, la = np.meshgrid(lon, lat)
    d_world = np.stack(
        [np.sin(lo) * np.cos(la), -np.cos(lo) * np.cos(la), np.sin(la)],
        axis=-1,
    ).astype(np.float32)

    # Camera forward axis in the projection convention.
    center = camera.unproject(torch.tensor([0.5, 0.5]), ROTATE_VIEW.T).numpy()
    fwd = center / np.linalg.norm(center)

    for _, rot, img in keyframes:
        if img is None:
            continue
        img = np.asarray(img)
        h, w = img.shape[:2]
        q = torch.tensor(np.asarray(rot, np.float32)).expand(height * width, 4)
        d_cam_t = quat.rotate_vec(quat.inverse(q), torch.from_numpy(d_world.reshape(-1, 3)))
        d_cam = d_cam_t.numpy()
        in_front = d_cam @ fwd > 0.05
        screen = camera.project(d_cam_t, ROTATE_VIEW).numpy()
        sx, sy = screen[:, 0], screen[:, 1]
        ok = in_front & (sx >= 0.0) & (sx < 1.0) & (sy >= 0.0) & (sy < 1.0)
        px = np.clip((sx * w).astype(np.int32), 0, w - 1)
        py = np.clip((sy * h).astype(np.int32), 0, h - 1)
        flat = canvas.reshape(-1, 4)
        src = img[py[ok], px[ok]]
        if src.shape[-1] == 3:
            src = np.concatenate([src, np.full(src.shape[:-1] + (1,), 255, np.uint8)], -1)
        flat[np.nonzero(ok)[0]] = src
    return canvas
