"""Cells, configurations, mixes and metrics are found by name, and the
result line keeps to the contract."""

import json

import pytest

from ofps_bench import run, spec
from ofps_bench.tests import tiny

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


def test_benchmark_json_names_resolve():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and "stream_fps" in e2e
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
            assert m["moves"] in e2e, (w["name"], m["name"])
        assert "det_off" in cell.config["limits"]


def test_new_files_are_found_without_a_code_edit(tmp_path):
    root = tiny.make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "ofps_bench/configs/codec_tiny.json").read_text())
    cfg.update(name="codec_wide", capacity=1024)
    (root / "ofps_bench/configs/codec_wide.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "ofps_bench/traffic/codec_tiny.json").read_text())
    mix.update(streams=3)
    (root / "ofps_bench/traffic/codec_three.json").write_text(json.dumps(mix))
    (root / "ofps_bench/metrics/steps_in_window.py").write_text(
        "def read(rec):\n    return float(len(rec.served.step_s))\n")
    bench["configs"].append(dict(bench["configs"][0], name="codec_wide",
                                 file="ofps_bench/configs/codec_wide.json"))
    bench["workloads"].append({"name": "codec_wide.b3", "config": "codec_wide",
                               "traffic": "codec_three", "chips": 1, "why": "added"})
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "stream_fps", "workloads": ["codec_wide.b3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("codec_wide.b3", root)
    assert cell.config["capacity"] == 1024 and cell.traffic["streams"] == 3
    assert "steps_in_window" in [m["name"] for m in cell.per_layer]
    out = run.run_cell(cell, 2**31 + 5, 1.0, True, "cpu", 0.0)
    assert out["metrics"]["steps_in_window"]["value"] == len(out["served"].step_s)
    assert out["correct"]


@pytest.mark.parametrize("tracing", [False, True])
def test_result_line_keys(tmp_path, tracing):
    cell = spec.load_cell("codec_tiny.b2", tiny.make_root(tmp_path))
    # A traced window long enough that the profiler, started 30% into it,
    # sees its steps on a slow CPU too (a codec tiny step takes ~0.3 s).
    out = run.run_cell(cell, 2**31 + 6, 3.0 if tracing else 1.0, tracing, "cpu", 0.0)
    device = {"platform": "gpu", "kind": "test", "count": 1, "memory_peak_bytes": 0}
    line = json.loads(json.dumps(run.result_line(out, device, tracing)))
    want = CONTRACT + (["breakdown"] if tracing else []) + ["checks"]
    assert list(line) == want
    names = {m["name"] for m in (cell.per_layer if tracing else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    if not tracing:
        # Every end-to-end metric the cell reports (the codec cells have no
        # step_p95_ms end to end).
        assert set(line["metrics"]) == names >= {"stream_fps", "setup_s"}
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
