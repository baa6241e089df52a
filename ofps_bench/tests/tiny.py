"""A tiny benchmark tree for the CPU tests: the cells' configurations and
mixes cut to a size the CPU runs in seconds, written under a temporary root
as a later change would add them (files and entries only)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from ofps_bench import spec

REPO = spec.ROOT


def make_root(tmp: Path) -> Path:
    """``tmp`` holding a BENCHMARK.json of two tiny cells, their files, and
    the benchmark's metric readers."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (tmp / "ofps_bench" / "configs").mkdir(parents=True)
    (tmp / "ofps_bench" / "traffic").mkdir(parents=True)
    shutil.copytree(REPO / "ofps_bench" / "metrics", tmp / "ofps_bench" / "metrics")
    cc = json.loads((REPO / "ofps_bench/configs/codec_track_1080p.json").read_text())
    cc.update(name="codec_tiny", width=320, height=176, capacity=512)
    cc["camera"]["aspect"] = 320 / 176
    fc = json.loads((REPO / "ofps_bench/configs/frames_track_1080p.json").read_text())
    fc.update(name="frames_tiny", width=256, height=144)
    fc["camera"]["aspect"] = 256 / 144
    ct = json.loads((REPO / "ofps_bench/traffic/codec_b8.json").read_text())
    ct.update(streams=2, bank_frames=8, warmup_steps=2, check_steps=3, trace_steps=2)
    ft = json.loads((REPO / "ofps_bench/traffic/frames_b8.json").read_text())
    ft.update(streams=2, bank_frames=6, warmup_steps=2, check_steps=5, trace_steps=2,
              block_px=32, block_step_px=4, pan_px=[1.0, 3.0])
    files = {"configs/codec_tiny.json": cc, "configs/frames_tiny.json": fc,
             "traffic/codec_tiny.json": ct, "traffic/frames_tiny.json": ft}
    for name, obj in files.items():
        (tmp / "ofps_bench" / name).write_text(json.dumps(obj))
    bench["configs"] = [
        dict(bench["configs"][0], name="codec_tiny", file="ofps_bench/configs/codec_tiny.json"),
        dict(bench["configs"][1], name="frames_tiny", file="ofps_bench/configs/frames_tiny.json"),
    ]
    bench["workloads"] = [
        {"name": "codec_tiny.b2", "config": "codec_tiny", "traffic": "codec_tiny", "chips": 1,
         "why": "tiny"},
        {"name": "frames_tiny.b2", "config": "frames_tiny", "traffic": "frames_tiny",
         "chips": 1, "why": "tiny"},
    ]
    for m in bench["per_layer"] + [m for m in bench["end_to_end"] if "workloads" in m]:
        kinds = {w.split("_")[0] for w in m["workloads"]}
        m["workloads"] = [w["name"] for w in bench["workloads"] if w["name"].split("_")[0] in kinds]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def add_cell(root: Path, cell: str, base: str, traffic: str, **changes) -> str:
    """A configuration ``base`` (a tiny one) with ``changes``, and its cell
    on ``traffic``, added to ``root`` as files and entries; returns the
    cell's name."""
    name = cell.split(".")[0]
    cfg = json.loads((root / f"ofps_bench/configs/{base}.json").read_text())
    cfg.update(name=name, **changes)
    (root / f"ofps_bench/configs/{name}.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == base)
    bench["configs"].append(dict(entry, name=name, file=f"ofps_bench/configs/{name}.json"))
    bench["workloads"].append({"name": cell, "config": name, "traffic": traffic, "chips": 1,
                               "why": "tiny"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


ALL4 = [{"name": n, "properties": {}} for n in ("almeida", "homography", "multiview", "libmv")]
