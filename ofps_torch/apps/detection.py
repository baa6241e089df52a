"""Headless motion-detection app (port of ``ofps_tpu.apps.detection``).

A decoder feeds the detector frame by frame; detected frames accumulate
into motion ranges, which are coalesced by ``max_frame_gap``, filtered by
``min_frames`` and exported as CSV, with per-stage times.

Each frame's vectors go up in one pinned copy (``apps.batch.FlowUploader``
at B=1) and the detector's sparse ``detect`` runs on ``device`` (default
the CUDA card; raises where there is none); the range bookkeeping stays on
the host.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

from ofps_torch.apps.batch import FlowUploader
from ofps_torch.core.properties import set_properties
from ofps_torch.decoders.base import create_decoder
from ofps_torch.detectors.base import create_detector
from ofps_torch.device import resolve_device
from ofps_torch.pipeline.runtime import DecoderFeed, PerfStats, RealtimeTimer


@dataclasses.dataclass
class DetectionSettings:
    """App settings (the reference's defaults)."""

    max_frame_gap: int = 10
    min_frames: int = 5
    realtime: bool = False


@dataclasses.dataclass
class DetectionResultSummary:
    frames: int = 0
    motion_ranges: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    perf: PerfStats = dataclasses.field(default_factory=PerfStats)

    def filtered_ranges(self, max_frame_gap: int, min_frames: int) -> List[Tuple[int, int]]:
        """Ranges closer than ``max_frame_gap`` merged, then those shorter
        than ``min_frames`` dropped."""
        out: List[Tuple[int, int]] = []
        for s, e in self.motion_ranges:
            if out and s - out[-1][1] <= max_frame_gap:
                out[-1] = (out[-1][0], e)
            else:
                out.append((s, e))
        return [(s, e) for s, e in out if e - s >= min_frames]

    def write_ranges_csv(self, path: str, settings: DetectionSettings):
        import csv

        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            for s, e in self.filtered_ranges(settings.max_frame_gap, settings.min_frames):
                w.writerow([s, e])


def _create_with_props(create, name: str, props: Dict[str, Any]):
    """``create(name)`` with ``props`` validated (and clamped) against its
    params first."""
    inst = create(name)
    if props:
        params = set_properties(name, inst.params, props)
        inst = create(name, **params._asdict())
    return inst


def run_detection(
    input_path: str,
    detector_name: str = "block_motion",
    decoder_plugin: Optional[str] = None,
    decoder_props: Optional[Dict[str, Any]] = None,
    detector_props: Optional[Dict[str, Any]] = None,
    settings: Optional[DetectionSettings] = None,
    capacity: int = 16384,
    max_frames: Optional[int] = None,
    overlay_dir: Optional[str] = None,
    device="cuda",
) -> DetectionResultSummary:
    """Decode a stream and accumulate detected-motion frame ranges.

    ``overlay_dir`` writes an HSV motion overlay PNG per detected frame.
    """
    dev = resolve_device(device)
    settings = settings or DetectionSettings()
    detector = _create_with_props(create_detector, detector_name, detector_props or {})
    decoder = create_decoder(input_path, decoder_plugin, device=dev, **(decoder_props or {}))
    if overlay_dir:
        os.makedirs(overlay_dir, exist_ok=True)

    uploader = FlowUploader(1, capacity, dev)
    res = DetectionResultSummary()
    feed = DecoderFeed(decoder, want_frames=bool(overlay_dir))
    timer = RealtimeTimer(decoder.get_framerate() if settings.realtime else None)

    current: Optional[Tuple[int, int]] = None
    try:
        for frame in feed:
            res.perf.add("decode", getattr(frame, "decode_time", 0.0))
            with res.perf.time("detect"):
                uploader.pack([frame])
                out = detector.detect(uploader.upload())
                detected = bool(out.detected[0]) and frame.has_mvs
            if overlay_dir and detected:
                from ofps_torch.apps.viz import flow_to_rgba, overlay, save_png

                rgba = flow_to_rgba(out.field[0].cpu().numpy())
                img = overlay(frame.frame, rgba) if frame.frame is not None else rgba
                save_png(os.path.join(overlay_dir, f"{res.frames:06}.png"), img)
            i = res.frames
            if detected:
                current = (current[0], i) if current else (i, i)
            elif current:
                res.motion_ranges.append(current)
                current = None
            res.frames += 1
            timer.tick()
            if max_frames is not None and res.frames >= max_frames:
                break
    finally:
        feed.stop()
    if current:
        res.motion_ranges.append(current)
    return res


def run_detection_config(config: Dict[str, Any], device="cuda") -> DetectionResultSummary:
    """Run from a JSON config (the JAX package's schema)::

        {"app": "detection",
         "decoder": {"input": "...", "plugin": null, "properties": {}},
         "detector": {"name": "block_motion", "properties": {}},
         "settings": {"max_frame_gap": 10, "min_frames": 5,
                      "realtime": false},
         "output": {"ranges_csv": "...", "perf_csv": "...",
                    "overlay_dir": "...", "timeline_png": "..."}}
    """
    dec = config.get("decoder", {})
    det = config.get("detector", {})
    s = config.get("settings", {})
    settings = DetectionSettings(
        max_frame_gap=int(s.get("max_frame_gap", 10)),
        min_frames=int(s.get("min_frames", 5)),
        realtime=bool(s.get("realtime", False)),
    )
    out = config.get("output", {})
    res = run_detection(
        dec["input"],
        detector_name=det.get("name", "block_motion"),
        decoder_plugin=dec.get("plugin"),
        decoder_props=dec.get("properties"),
        detector_props=det.get("properties"),
        settings=settings,
        max_frames=config.get("max_frames"),
        overlay_dir=out.get("overlay_dir"),
        device=device,
    )
    if out.get("ranges_csv"):
        res.write_ranges_csv(out["ranges_csv"], settings)
    if out.get("perf_csv"):
        res.perf.write_csv(out["perf_csv"])
    if out.get("timeline_png"):
        from ofps_torch.apps.viz import plot_detection_timeline

        plot_detection_timeline(
            out["timeline_png"],
            res.filtered_ranges(settings.max_frame_gap, settings.min_frames),
            res.frames,
        )
    return res
