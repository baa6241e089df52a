"""The cells' inputs, made from ``--seed`` by one generator per input kind,
parametrised by the traffic file.  The same seed gives the same inputs.

* ``codec_mvec``: per stream a bank of ``bank_frames`` frames of H.264-style
  macroblock vectors (one per 16x16 block of the frame), frame 0 empty (the
  GOP's I-frame), then a camera rotation of ``rot_deg`` degrees a frame about
  an axis of the stream's own, ``intra`` of the blocks dropped, ``outliers``
  of the rest replaced by uniform +-``outlier_px`` vectors, quantised to
  ``1 / subpel`` px.  Written as ``.mvec`` files (the port's replay format);
  a stream cycles through its bank.
* ``frames``: per stream a bank of ``bank_frames`` gray uint8 frames cut
  from a blurred-noise panorama, panning ``pan_px`` px a frame in a direction
  of the stream's own, with a ``block_px`` square block of another texture
  that moves ``block_step_px`` a frame over the first ``block_moving`` share of
  the bank and rests in the scene after.  Made on the card, kept in pinned
  host memory; a stream plays its bank forwards and backwards, so that
  consecutive frames always differ by the pan.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import List, NamedTuple

import numpy as np
import torch

from ofps_bench.reference import quat
from ofps_bench.reference.camera import ROTATE_VIEW, StandardCamera


class CodecBank(NamedTuple):
    pos: List[List[np.ndarray]]  # [stream][frame] (n, 2) float32
    motion: List[List[np.ndarray]]  # [stream][frame] (n, 2) float32
    truth: np.ndarray  # (streams, frames, 4) float64 delta rotation of each frame


def lattice(width: int, height: int, block: int) -> np.ndarray:
    """Centres of the ``block`` x ``block`` macroblocks, [0, 1]-normalised."""
    xs = (np.arange(width // block) * block + block / 2) / width
    ys = (np.arange(-(-height // block)) * block + block / 2) / height
    return np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2).astype(np.float32)


def codec_bank(seed: int, streams: int, config, traffic) -> CodecBank:
    w, h = config["width"], config["height"]
    cam = StandardCamera.create(config["camera"]["aspect"], config["camera"]["fov_y"])
    pts = lattice(w, h, traffic["block"])
    pts_t = torch.from_numpy(pts)
    world = cam.unproject(pts_t, ROTATE_VIEW)  # the lattice's rays, once
    scale = np.array([traffic["subpel"] * w, traffic["subpel"] * h], np.float32)
    lo, hi = traffic["rot_deg"]
    n = traffic["bank_frames"]
    pos, motion = [], []
    truth = np.zeros((streams, n, 4))
    truth[:, :, 0] = 1.0
    for s in range(streams):
        rng = np.random.default_rng([seed, s])
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        half = np.radians(rng.uniform(lo, hi, n - 1)) / 2
        q = np.concatenate([np.cos(half)[:, None], np.sin(half)[:, None] * axis], axis=1)
        truth[s, 1:] = q
        # The estimators return the inverse of the rotation that moves the
        # points: the flow is made by q's inverse.
        rot = quat.to_matrix4(quat.conj(torch.from_numpy(q)).float())  # (n - 1, 4, 4)
        moved = torch.einsum("fij,pj->fpi", rot[:, :3, :3], world) + rot[:, None, :3, 3]
        mv = (cam.project(moved, ROTATE_VIEW) - pts_t).numpy()
        bad = rng.random(mv.shape[:2]) < traffic["outliers"]
        px = traffic["outlier_px"]
        mv[bad] = rng.uniform(-px, px, (int(bad.sum()), 2)) / (w, h)
        mv = (np.round(mv * scale) / scale).astype(np.float32)
        keep = rng.random(mv.shape[:2]) >= traffic["intra"]
        pos.append([np.zeros((0, 2), np.float32)] + [pts[k] for k in keep])
        motion.append([np.zeros((0, 2), np.float32)] + [m[k] for m, k in zip(mv, keep)])
    return CodecBank(pos, motion, truth)


def write_mvec(path: Path, pos: List[np.ndarray], motion: List[np.ndarray]) -> None:
    """``.mvec``: per frame a little-endian u32 count, then that many
    (pos.x, pos.y, motion.x, motion.y) little-endian float32 records."""
    with open(path, "wb") as f:
        for p, m in zip(pos, motion):
            f.write(np.uint32(len(p)).astype("<u4").tobytes())
            f.write(np.concatenate([p, m], axis=1).astype("<f4").tobytes())


def _blur_noise(gen: torch.Generator, lead, h: int, w: int, sigma: float, device):
    """(*lead, h, w) float32 noise blurred by a separable Gaussian (shifted
    sums: no convolution library, so every run computes the same bits)."""
    r = int(math.ceil(3 * sigma))
    x = torch.randn(tuple(lead) + (h + 2 * r, w + 2 * r), generator=gen, device=device)
    taps = [math.exp(-(i * i) / (2 * sigma * sigma)) for i in range(-r, r + 1)]
    norm = sum(taps)
    y = sum(k / norm * x[..., :, i : i + w] for i, k in enumerate(taps))
    return sum(k / norm * y[..., i : i + h, :] for i, k in enumerate(taps))


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(128.0 + 400.0 * x), 0, 255).to(torch.uint8)


def pan_offsets(seed: int, streams: int, traffic) -> np.ndarray:
    """(streams, bank_frames, 2) integer (dy, dx) camera offsets."""
    n = traffic["bank_frames"]
    out = np.zeros((streams, n, 2), np.int64)
    lo, hi = traffic["pan_px"]
    for s in range(streams):
        rng = np.random.default_rng([seed, s])
        theta, mag = rng.uniform(0, 2 * math.pi), rng.uniform(lo, hi)
        k = np.arange(n)
        out[s, :, 0] = np.round(k * mag * math.sin(theta))
        out[s, :, 1] = np.round(k * mag * math.cos(theta))
    return out


def frames_bank(seed: int, streams: int, config, traffic, device) -> torch.Tensor:
    """(bank_frames, streams, H, W) uint8 in pinned host memory (on the CPU:
    ordinary memory)."""
    h, w = config["height"], config["width"]
    n = traffic["bank_frames"]
    offs = pan_offsets(seed, streams, traffic)
    m = int(np.abs(offs).max()) + 1
    gen = torch.Generator(device=device).manual_seed(seed)
    sigma = traffic["texture_sigma_px"]
    pano = _to_u8(_blur_noise(gen, (streams,), h + 2 * m, w + 2 * m, sigma, device))
    side = traffic["block_px"]
    block = _to_u8(_blur_noise(gen, (streams,), side, side, sigma, device))
    moving = int(round(n * traffic["block_moving"]))
    step = traffic["block_step_px"]
    y0, x0 = (h - side) // 2, w // 4
    dev = torch.empty((n, streams, h, w), dtype=torch.uint8, device=device)
    for s in range(streams):
        for k in range(n):
            dy, dx = offs[s, k]
            dev[k, s] = pano[s, m + dy : m + dy + h, m + dx : m + dx + w]
            # The block's place in the scene, seen from the panned camera.
            by = y0 - dy
            bx = x0 + step * min(k, moving) - dx
            dev[k, s, by : by + side, bx : bx + side] = block[s]
    host = torch.empty(dev.shape, dtype=torch.uint8, pin_memory=torch.device(device).type == "cuda")
    host.copy_(dev)
    return host


def bank_index(step: int, frames: int) -> int:
    """The bank frame of ``step``: forwards, then backwards (0, 1, .., n-1,
    n-2, .., 1, 0, 1, ..)."""
    k = step % (2 * frames - 2)
    return k if k < frames else 2 * frames - 2 - k
