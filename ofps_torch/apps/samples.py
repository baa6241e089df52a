"""The sample inputs and configs that ``BASELINE.json`` names, made with
the port's own parts (port of ``samples/make_samples.py``).

    python -m ofps_torch.apps.samples [OUTDIR] [--no-video]

Writes into OUTDIR (default ``samples/torch_data/``), and nowhere else:

* ``synthetic_rot.mvec`` and ``synthetic_rot_gt.csv``: a camera rotation
  schedule of 15 steps seen on the 50x50 synthetic grid (the estimators'
  fixture, :mod:`ofps_torch.apps.synthetic`), after an empty first frame;
* ``detect.avi`` (30 frames, a burst of motion) and ``cctv.avi`` (two
  minutes at 30 fps with four motion events over long still spans, GoP
  240), MPEG-4 clips from the port's test encoder;
* the configs ``synthetic_almeida_gt.json``, ``synthetic_all_gt.json``,
  ``basic_detect.json`` and ``cctv_detect.json``, every path in them
  pointing into OUTDIR.  Run one with
  ``python -m ofps_torch.apps.cli [--device cpu] run-config OUTDIR/<name>``.

The clips need FFmpeg's libraries.  ``--no-video`` writes only the
``.mvec`` stream, its ground truth and the two tracking configs, for a
machine without FFmpeg.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np

from ofps_torch.apps import gt as gtmod
from ofps_torch.apps.synthetic import euler_deg, synthetic_field
from ofps_torch.core import quat
from ofps_torch.core.camera import StandardCamera
from ofps_torch.decoders.mvec import write_mvec_frame

DEFAULT_OUTDIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "samples", "torch_data")

# Panning rotation schedule (roll, pitch, yaw deg per frame): ramp up yaw,
# mix in pitch, return.
DELTAS_DEG = (
    [(0.0, 0.0, 0.1 * k) for k in range(5)]
    + [(0.05, 0.1, 0.4)] * 5
    + [(0.0, -0.1, -0.2)] * 5
)
# A motion burst in the middle of a still scene, for detection.
DETECT_CLIP = dict(width=320, height=240, frames=30, gop=60, dx=1.5, dy=0.0, pattern="noise")
# The reference's 30-minute burglary evaluation shape at two minutes: four
# events of different lengths, two crossing GoP boundaries.
CCTV_EVENTS = ((400, 460), (1190, 1310), (2230, 2275), (3100, 3220))
CCTV_CLIP = dict(width=320, height=240, frames=3600, gop=240, dx=1.5, dy=0.5, pattern="noise",
                 events=CCTV_EVENTS)


def make_rotation_stream(path_mvec: str, path_gt: str, deltas_deg, camera) -> None:
    """Write an ``.mvec`` stream and its ground-truth CSV for a per-frame
    rotation schedule: an empty first frame with the identity pose, then
    one frame of the synthetic field per (roll, pitch, yaw) delta."""
    rows = [gtmod.GroundTruthRow(frame=1, fov_x=90.0, fov_y=90.0,
                                 rot=quat.identity().numpy(), pos=np.zeros(3))]
    acc = quat.identity()
    with open(path_mvec, "wb") as f:
        write_mvec_frame(f, np.zeros((0, 2)), np.zeros((0, 2)))
        for k, (r, p, y) in enumerate(deltas_deg):
            q = euler_deg(r, p, y)
            flow = synthetic_field(camera, q, device="cpu")
            keep = flow.mask > 0.5
            write_mvec_frame(f, flow.pos[keep].numpy(), flow.motion[keep].numpy())
            acc = quat.mul(q, acc)
            rows.append(gtmod.GroundTruthRow(frame=k + 2, fov_x=90.0, fov_y=90.0,
                                             rot=acc.numpy().copy(), pos=np.zeros(3)))
    gtmod.write_ground_truth(path_gt, rows)


def sample_configs(outdir: str) -> Dict[str, dict]:
    """The four configs (``samples/make_samples.py``'s keys and values),
    their paths in ``outdir``."""
    def at(name):
        return os.path.join(outdir, name)

    def tracking(estimators, prefix):
        return {
            "app": "tracking",
            "decoder": {"input": at("synthetic_rot.mvec")},
            "camera_aspect": 1.0,
            "camera_fov_y": 90.0,
            "estimators": estimators,
            "ground_truth": at("synthetic_rot_gt.csv"),
            "output": {"stats_csv_prefix": at(prefix)},
        }

    def detection(clip, min_frames, ranges):
        return {
            "app": "detection",
            "decoder": {"input": at(clip)},
            "detector": {"name": "block_motion", "properties": {"target_motion": 0.003}},
            "settings": {"max_frame_gap": 10, "min_frames": min_frames},
            "output": {"ranges_csv": at(ranges)},
        }

    return {
        "synthetic_almeida_gt.json": tracking(
            [{"name": "almeida", "properties": {"use_ransac": True}}], "stats_"),
        "synthetic_all_gt.json": tracking(
            [{"name": n} for n in ("almeida", "homography", "multiview", "libmv")], "all_stats_"),
        "basic_detect.json": detection("detect.avi", 3, "ranges.csv"),
        "cctv_detect.json": detection("cctv.avi", 5, "cctv_ranges.csv"),
    }


def write_samples(outdir: str = DEFAULT_OUTDIR, video: bool = True) -> List[str]:
    """Write the data and the configs into ``outdir``; returns the configs'
    paths.  ``video=False`` leaves out the two clips and their configs.
    Raises where ``video`` is set and FFmpeg's libraries are missing."""
    outdir = os.path.abspath(outdir)
    os.makedirs(outdir, exist_ok=True)
    configs = sample_configs(outdir)
    if video:
        from ofps_torch.decoders.av import encode_test_video

        encode_test_video(configs["basic_detect.json"]["decoder"]["input"], **DETECT_CLIP)
        encode_test_video(configs["cctv_detect.json"]["decoder"]["input"], **CCTV_CLIP)
    else:
        configs = {n: c for n, c in configs.items() if c["app"] == "tracking"}
    make_rotation_stream(os.path.join(outdir, "synthetic_rot.mvec"),
                         os.path.join(outdir, "synthetic_rot_gt.csv"),
                         DELTAS_DEG, StandardCamera.create(1.0, 90.0))
    paths = []
    for name, cfg in configs.items():
        paths.append(os.path.join(outdir, name))
        with open(paths[-1], "w") as f:
            json.dump(cfg, f, indent=2)
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ofps_torch.apps.samples",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("outdir", nargs="?", default=DEFAULT_OUTDIR)
    ap.add_argument("--no-video", action="store_true",
                    help="write only the .mvec stream, its ground truth and the tracking configs")
    args = ap.parse_args(argv)
    paths = write_samples(args.outdir, video=not args.no_video)
    names = [os.path.basename(p) for p in paths]
    print(f"samples written to {os.path.abspath(args.outdir)}: {names}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
