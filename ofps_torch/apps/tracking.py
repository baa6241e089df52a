"""Headless camera-tracking app (port of ``ofps_tpu.apps.tracking``).

A decoder feeds every enabled estimator each frame; poses integrate as
``motion_step`` does, and the results compare against a ground-truth CSV
with per-frame error statistics and CSV / PNG export.

Per frame on ``device`` (default the CUDA card; raises where there is
none): the vectors go up in one pinned copy (``apps.batch.FlowUploader``
at B=1), one ``StreamPipeline.step_from_flow`` runs the estimators as one
CUDA graph replay (masked RANSAC, draws from a generator seeded with
``seed``), and the frame's rotations and translations come back in one
copy.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ofps_torch.apps import gt as gtmod
from ofps_torch.apps.batch import FlowUploader
from ofps_torch.apps.detection import _create_with_props
from ofps_torch.core.camera import StandardCamera
from ofps_torch.decoders.base import create_decoder
from ofps_torch.device import resolve_device
from ofps_torch.estimators.base import create_estimator
from ofps_torch.parallel.stream import StreamPipeline
from ofps_torch.pipeline.runtime import DecoderFeed, LivePipeline, PerfStats, RealtimeTimer


class KeyframeKeeper:
    """Pose-diverse keyframe set: (frame index, rotation, payload) where
    the payload is the decoded image when the decoder provides one.

    Over capacity it evicts the frame whose summed angular distance to its
    5 nearest kept poses is smallest (the most redundant view); with two or
    fewer kept frames, the oldest goes.
    """

    def __init__(self, max_frames: int = 10):
        self.max_frames = max_frames
        self.frames: List[tuple] = []  # (frame_idx, rot wxyz, payload)

    def add(self, frame_idx: int, rot: np.ndarray, payload=None):
        self.frames.append((frame_idx, np.asarray(rot, np.float64), payload))
        if len(self.frames) > self.max_frames:
            self._remove_least_significant()

    def _remove_least_significant(self):
        if len(self.frames) <= 2:
            self.frames.pop(0)
            return
        n = len(self.frames)
        rots = np.stack([r for _, r, _ in self.frames])  # (n, 4)
        dots = np.abs(rots @ rots.T)
        ang = 2.0 * np.arccos(np.clip(dots, -1.0, 1.0))
        k = min(5, n)
        nearest = np.partition(ang, k - 1, axis=1)[:, :k].sum(axis=1)
        self.frames.pop(int(np.argmin(nearest)))

    def export(self, prefix: str) -> str:
        """Write ``{prefix}keyframes.csv`` (+ a PNG per image payload)."""
        from ofps_torch.apps.viz import save_png

        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
        path = prefix + "keyframes.csv"
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow("frame rot_w rot_i rot_j rot_k image".split())
            for idx, rot, payload in self.frames:
                img = ""
                if payload is not None:
                    img = f"{prefix}kf_{idx:06d}.png"
                    save_png(img, np.asarray(payload))
                w.writerow([idx, *[f"{v:.8f}" for v in rot], img])
        return path


@dataclasses.dataclass
class EstimatorTrack:
    """Per-estimator accumulated results (host numpy arrays)."""

    name: str
    transforms: List[np.ndarray] = dataclasses.field(default_factory=list)
    translations: List[np.ndarray] = dataclasses.field(default_factory=list)
    poses_rot: List[np.ndarray] = dataclasses.field(default_factory=list)
    poses_pos: List[np.ndarray] = dataclasses.field(default_factory=list)
    keyframes: KeyframeKeeper = dataclasses.field(default_factory=KeyframeKeeper)

    def pose_stats(self):
        return gtmod.pose_stats(self.transforms, self.poses_rot)

    def err_stats(self, truth):
        return gtmod.calc_err(truth, self.transforms)

    def avg_err(self, truth):
        return gtmod.calc_avg_err(truth, self.transforms)


@dataclasses.dataclass
class TrackingResult:
    frames: int
    tracks: List[EstimatorTrack]
    perf: PerfStats  # stages "decode", "estimate" (host clock)
    # How the estimators ran: CUDA graphs captured, replays, eager calls.
    graphs: int = 0
    graph_replays: int = 0
    eager_runs: int = 0


def _estimator_with_props(name: str, props: Dict[str, Any]):
    return _create_with_props(create_estimator, name, props)


def run_tracking(
    input_path: str,
    estimators: List[Dict[str, Any]],
    camera_aspect: float,
    camera_fov_y: float,
    decoder_plugin: Optional[str] = None,
    capacity: int = 16384,
    realtime: bool = False,
    max_frames: Optional[int] = None,
    seed: int = 0,
    want_frames: bool = False,
    decoder_props=None,
    props_hook=None,
    device="cuda",
) -> TrackingResult:
    """Track camera motion with every listed estimator on one stream.

    ``estimators``: [{"name": ..., "properties": {...}}, ...].
    ``want_frames=True`` asks the decoder for RGBA frames so keyframes
    carry image payloads (keyframe gallery / panorama export).
    ``props_hook(frame_idx, props) -> props`` may change the per-frame
    properties (``{"estimators": (dict, ...), "detector": {}}``) before a
    frame: its values are 0-d tensors on ``device``, so a value written in
    place (``props["estimators"][0]["inlier_angle_deg"].fill_(2.0)``), or
    a returned dict with new values, reaches that frame's step with no new
    CUDA graph.
    """
    dev = resolve_device(device)
    insts = [
        _estimator_with_props(e["name"], e.get("properties") or {})
        for e in estimators
        if e.get("enabled", True)
    ]
    camera = StandardCamera.create(camera_aspect, camera_fov_y)
    pipe = StreamPipeline(camera=camera, estimators=insts, device=dev)
    live = LivePipeline(pipe, 1, 1, 1, from_flow=True)  # no frames on the MV input
    generator = torch.Generator(device=dev).manual_seed(seed)
    uploader = FlowUploader(1, capacity, dev)

    decoder = create_decoder(input_path, decoder_plugin, device=dev, **(decoder_props or {}))
    feed = DecoderFeed(decoder, want_frames=want_frames)
    timer = RealtimeTimer(decoder.get_framerate() if realtime else None)
    perf = PerfStats()
    tracks = [EstimatorTrack(name=i.name) for i in insts]
    frames = 0

    try:
        for frame in feed:
            perf.add("decode", getattr(frame, "decode_time", 0.0))
            with perf.time("estimate"):
                uploader.pack([frame])
                flow = uploader.upload()
                if props_hook is not None:
                    live.props = props_hook(frames, live.props)
                _, out = live.step(flow, generator)
                if tracks:
                    # (E, 14): delta rotation, delta translation, rotation,
                    # position per estimator, fetched in one copy.
                    host = torch.cat([
                        torch.cat([out.delta_rot[t], out.delta_tr[t], out.rot[t], out.pos[t]], -1)
                        for t in range(len(tracks))
                    ]).cpu().numpy()
            for t, track in enumerate(tracks):
                track.transforms.append(host[t, 0:4])
                track.translations.append(host[t, 4:7])
                track.poses_rot.append(host[t, 7:11])
                track.poses_pos.append(host[t, 11:14])
                track.keyframes.add(frames, track.poses_rot[-1],
                                    payload=getattr(frame, "frame", None))
            frames += 1
            timer.tick()
            if max_frames is not None and frames >= max_frames:
                break
    finally:
        feed.stop()

    return TrackingResult(frames=frames, tracks=tracks, perf=perf, graphs=len(pipe._graphs),
                          graph_replays=pipe.graph_replays, eager_runs=pipe.eager_runs)


def run_tracking_config(config: Dict[str, Any], device="cuda") -> TrackingResult:
    """Run from a JSON config (the JAX package's schema)::

        {"app": "tracking",
         "decoder": {"input": "...", "plugin": null, "properties": {}},
         "camera_aspect": 1.777, "camera_fov_y": 90.0,
         "estimators": [{"name": "almeida", "enabled": true,
                         "properties": {}}, ...],
         "ground_truth": "gt.csv" | null,
         "realtime_processing": false,
         "output": {"stats_csv_prefix": "out/stats_", "perf_csv": "...",
                    "plot_prefix": "...", "keyframes_prefix": "...",
                    "panorama_prefix": "..."}}
    """
    dec = config.get("decoder", {})
    out = config.get("output", {})
    aspect = float(config.get("camera_aspect", 16.0 / 9.0))
    fov_y = float(config.get("camera_fov_y", 90.0))
    res = run_tracking(
        dec["input"],
        config.get("estimators", [{"name": "almeida"}]),
        camera_aspect=aspect,
        camera_fov_y=fov_y,
        decoder_plugin=dec.get("plugin"),
        decoder_props=dec.get("properties"),
        realtime=bool(config.get("realtime_processing", False)),
        max_frames=config.get("max_frames"),
        want_frames=bool(out.get("keyframes_prefix") or out.get("panorama_prefix")),
        device=device,
    )

    truth = None
    if config.get("ground_truth"):
        truth = gtmod.load_ground_truth(config["ground_truth"])

    for track in res.tracks:
        pose = track.pose_stats()
        err = track.err_stats(truth) if truth else []
        if out.get("stats_csv_prefix"):
            gtmod.write_stats_csv(out["stats_csv_prefix"] + track.name + ".csv", err, pose)
        if out.get("keyframes_prefix"):
            track.keyframes.export(out["keyframes_prefix"] + track.name + "_")
        if out.get("panorama_prefix"):
            from ofps_torch.apps.viz import keyframe_panorama, save_png

            save_png(out["panorama_prefix"] + track.name + ".png",
                     keyframe_panorama(track.keyframes.frames,
                                       StandardCamera.create(aspect, fov_y)))
        if out.get("plot_prefix"):
            from ofps_torch.apps.viz import plot_tracking

            plot_tracking(out["plot_prefix"] + track.name + ".png", pose, err,
                          title=track.name)
        if truth:
            avg = track.avg_err(truth)
            deg = 180.0 / np.pi
            print(
                f"{track.name}: avg err {avg[0]*deg:.4f} deg "
                f"(r {avg[1]*deg:.4f}, p {avg[2]*deg:.4f}, y {avg[3]*deg:.4f})"
            )
    if out.get("perf_csv"):
        res.perf.write_csv(out["perf_csv"])
    return res
