"""The CCTV-scale motion-event scenario through the port (slow), with the
assertions of ``tests/test_cctv_scenario.py``: a two-minute 30 fps clip
with four motion events over long still spans, every event detected, no
false positive, and the ranges CSV round-tripping.

The clip and its config come from the port's full sample generator
(``python -m ofps_torch.apps.samples OUTDIR``, FFmpeg needed), which is
checked here to write its data and its four configs into OUTDIR and
nowhere else; detection runs from ``cctv_detect.json`` on the CPU.
"""

import json
from pathlib import Path

import pytest

from ofps_torch.apps import samples as tsam
from ofps_torch.apps.detection import DetectionSettings, run_detection_config
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
EVENTS = [(400, 460), (1190, 1310), (2230, 2275), (3100, 3220)]


@pytest.mark.slow
def test_cctv_two_minute_scenario(tmp_path):
    before = {p.name: p.read_bytes() for p in (ROOT / "samples").glob("*.json")}
    out = tmp_path / "samples"
    assert tsam.main([str(out)]) == 0
    assert sorted(p.name for p in out.iterdir()) == sorted(
        ["basic_detect.json", "cctv.avi", "cctv_detect.json", "detect.avi",
         "synthetic_all_gt.json", "synthetic_almeida_gt.json", "synthetic_rot.mvec",
         "synthetic_rot_gt.csv"])
    assert {p.name: p.read_bytes() for p in (ROOT / "samples").glob("*.json")} == before
    assert [tuple(e) for e in tsam.CCTV_EVENTS] == EVENTS

    config = json.loads((out / "cctv_detect.json").read_text())
    res = run_detection_config(config, device="cpu")
    assert res.frames == tsam.CCTV_CLIP["frames"] == 3600
    s = config["settings"]
    settings = DetectionSettings(max_frame_gap=s["max_frame_gap"], min_frames=s["min_frames"])
    ranges = res.filtered_ranges(settings.max_frame_gap, settings.min_frames)

    # Every event detected (a range overlapping each window)...
    for s, e in EVENTS:
        hits = [r for r in ranges if r[1] >= s and r[0] <= e]
        assert hits, f"event ({s},{e}) missed; ranges={ranges}"
    # ... and no false positive: every range lies within an event window
    # (plus codec latency slack: vectors trail the texture by a frame or
    # two, and a GoP I-frame inside an event may split it).
    slack = 8
    for r in ranges:
        assert any(r[0] >= s - slack and r[1] <= e + slack for s, e in EVENTS), \
            f"false positive range {r}; events={EVENTS}"
    assert len(ranges) == len(EVENTS), (ranges, EVENTS)

    # The config's ranges CSV round-trips.
    rows = [tuple(int(v) for v in line.split(","))
            for line in Path(config["output"]["ranges_csv"]).read_text().strip().splitlines()]
    assert rows == ranges
