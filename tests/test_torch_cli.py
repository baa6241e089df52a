"""The port's command line (``python -m ofps_torch.apps.cli``) and watch
mode against ofps_tpu's on the CPU (``--device cpu``).

* ``info`` lists what JAX's lists; ``motion-extract`` writes the same
  bytes as JAX's from the same clip; ``flow-extract`` writes the same
  ``.flo`` files within 1e-5 px (the densify sums in another order).
* ``run-config`` (detection and tracking), ``run-batch``, ``bench-decode``,
  ``bench-e2e`` (JAX's JSON keys) and ``stats`` exit 0 with their outputs.
* ``WatchState``'s ``/state.json`` payload equals JAX's for the same
  pushes; ``run_watch`` serves 3 frames over loopback.
* Every entry point given no device raises where CUDA is not available.
"""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from ofps_torch.apps import cli as tcli
from ofps_torch.apps import watch as twatch
from ofps_tpu.apps import cli as jcli
from ofps_tpu.apps import watch as jwatch
from ofps_tpu.decoders.flo import read_flo
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = ["--device", "cpu"]
# The keys of bench-e2e's JSON line (ofps_tpu/apps/cli.py).
E2E_KEYS = ["metric", "streams", "frames", "decode_wait_ms_avg", "step_ms_avg",
            "fetch_ms_avg", "value", "wall_fps_incl_compile", "decode_keeps_up"]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 160x120 MPEG-4 clip translating 1 px per frame (8 frames), its
    ``.mvec`` dump by JAX's motion-extract, and a tracking config over it."""
    from ofps_tpu.decoders.av import encode_test_video

    d = tmp_path_factory.mktemp("cli")
    path = str(d / "clip.avi")
    encode_test_video(path, 160, 120, frames=8, gop=30, dx=1.0, dy=0.0)
    mvec = str(d / "clip.mvec")
    assert jcli.main(["motion-extract", path, mvec]) == 0
    tracking = {
        "app": "tracking",
        "decoder": {"input": mvec},
        "camera_aspect": 4 / 3,
        "camera_fov_y": 90.0,
        "estimators": [{"name": "almeida", "properties": {"num_iters": 8}}],
        "detector": {"name": "block_motion"},
        "output": {"stats_csv_prefix": str(d / "stats" / "stats_"),
                   "perf_csv": str(d / "stats" / "perf.csv")},
    }
    os.makedirs(d / "stats")
    return d, path, mvec, tracking


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)
    return str(path)


def test_info_lists_what_jax_lists(capsys):
    assert jcli.main(["info"]) == 0
    ref = capsys.readouterr().out
    assert tcli.main(CPU + ["info"]) == 0
    got = capsys.readouterr().out
    assert got == ref and "almeida, homography, libmv, multiview" in got


def test_motion_extract_writes_jax_bytes(clip):
    d, path, mvec, _ = clip
    out = str(d / "port.mvec")
    assert tcli.main(CPU + ["motion-extract", path, out]) == 0
    with open(out, "rb") as f, open(mvec, "rb") as g:
        got, ref = f.read(), g.read()
    assert got == ref and len(got) > 1000


def test_flow_extract_matches_jax(clip):
    d, _, mvec, _ = clip
    size = ["--width", "40", "--height", "30"]
    assert jcli.main(["flow-extract", mvec, str(d / "jflo")] + size) == 0
    assert tcli.main(CPU + ["flow-extract", mvec, str(d / "tflo"), "--draw-flow"] + size) == 0
    names = sorted(n for n in os.listdir(d / "jflo") if n.endswith(".flo"))
    assert len(names) == 8
    assert sorted(n for n in os.listdir(d / "tflo") if n.endswith(".flo")) == names
    assert len([n for n in os.listdir(d / "tflo") if n.endswith(".png")]) == 8
    for n in names:
        got, ref = read_flo(str(d / "tflo" / n)), read_flo(str(d / "jflo" / n))
        assert got.shape == (30, 40, 2)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert np.median(read_flo(str(d / "tflo" / names[-1]))[..., 0]) > 0.03


def test_run_config_batch_and_stats_exit_0(clip, capsys):
    d, _, mvec, tracking = clip
    det = {
        "app": "detection",
        "decoder": {"input": mvec},
        "detector": {"name": "block_motion", "properties": {"target_motion": 0.004}},
        "settings": {"max_frame_gap": 2, "min_frames": 1},
        "output": {"ranges_csv": str(d / "r.csv")},
    }
    assert tcli.main(CPU + ["run-config", _write(d / "det.json", det)]) == 0
    assert os.path.exists(d / "r.csv")
    assert tcli.main(CPU + ["run-config", _write(d / "trk.json", tracking)]) == 0
    out = capsys.readouterr().out
    assert "processed 8 frames with ['almeida']" in out and "estimate: avg" in out
    assert os.path.exists(d / "stats" / "stats_almeida.csv")
    assert tcli.main(CPU + ["stats", str(d / "stats"), "--out", str(d / "sum.csv")]) == 0
    assert "almeida: avg err" in capsys.readouterr().out and os.path.exists(d / "sum.csv")
    assert tcli.main(CPU + ["run-batch", mvec, mvec, "--frames", "4"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("2 streams x 4 frames") and "detections per stream" in out
    assert tcli.main(CPU + ["bench-decode", mvec, "--streams", "2"]) == 0
    assert capsys.readouterr().out.startswith("16 frames from 2 feed(s)")
    assert tcli.main(CPU + ["run-config", _write(d / "bad.json", {"app": "nope"})]) == 1


def test_bench_e2e_prints_jax_json_line(clip, capsys):
    _, _, mvec, _ = clip
    assert tcli.main(CPU + ["bench-e2e", "--input", mvec, "--streams", "2", "--frames", "6",
                            "--width", "160", "--height", "120", "--estimators", "almeida",
                            "--fetch-lag", "2"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(rec) == E2E_KEYS
    assert rec["metric"] == "e2e_stream_fps" and rec["streams"] == 2 and rec["frames"] == 6
    assert rec["value"] > 0 and isinstance(rec["decode_keeps_up"], bool)


def _push_all(state):
    overlay = np.zeros((16, 16, 4), np.float32)
    overlay[4:12, 4:12] = [1.0, 0.2, 0.2, 1.0]
    state.push(0, overlay, True, ["almeida", "libmv"], [[0.1, -0.2, 0.3], [0.0, 1.0, 2.0]],
               quats=[[1.0, 0.0, 0.0, 0.0], [0.9, 0.1, 0.0, 0.0]],
               positions=[[0.0, 0.5, 1.0], [1.0, 0.0, 0.0]])
    for i in range(1, 15):
        state.push(i, None, i % 2 == 0, ["almeida", "libmv"],
                   [[float(i), 0.0, 0.0], [0.0, float(i), 0.0]],
                   quats=[[1.0, 0.0, 0.0, 0.0]] * 2 if i % 3 else None)
    state.finish()


def test_watch_state_payload_equals_jax(monkeypatch, tmp_path):
    got, ref = twatch.WatchState(trace_len=4, kf_every=5), jwatch.WatchState(trace_len=4, kf_every=5)
    _push_all(got)
    _push_all(ref)
    assert json.dumps(got.snapshot()) == json.dumps(ref.snapshot())
    assert twatch._PAGE == jwatch._PAGE
    assert got.jpeg_seq == ref.jpeg_seq == 1
    # Without OpenCV the overlay goes out as the port's own PNG.
    import matplotlib.pyplot as plt

    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    img = (np.arange(16 * 16 * 4) % 251).astype(np.uint8).reshape(16, 16, 4)
    blob, ctype = twatch._encode_image(img)
    assert ctype == "image/png"
    (tmp_path / "w.png").write_bytes(blob)
    np.testing.assert_array_equal(plt.imread(str(tmp_path / "w.png")), img / np.float32(255.0))


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read()


def test_run_watch_serves_frames_over_loopback(clip):
    _, _, _, tracking = clip
    box = []
    th = threading.Thread(target=twatch.run_watch, daemon=True, kwargs=dict(
        config=dict(tracking, output={}), port=0, max_frames=3, _server_box=box, device="cpu"))
    th.start()
    t0 = time.time()
    while not box and time.time() - t0 < 60:
        time.sleep(0.05)
    assert box, "server did not start"
    port = box[0].server_address[1]
    try:
        assert b"ofps-tpu live view" in _get(port, "/")
        snap = None
        while time.time() - t0 < 120:
            snap = json.loads(_get(port, "/state.json"))
            if snap["done"]:
                break
            time.sleep(0.2)
        assert snap and snap["done"] and snap["frame"] == 2
        est = snap["estimators"]
        assert [e["name"] for e in est] == ["almeida"] and len(est[0]["trace"]) == 3
        assert all(np.isfinite(v) for e in est[0]["trace"] for v in e)
        assert abs(np.linalg.norm(est[0]["q"]) - 1.0) < 1e-3
        assert snap["detected"] in (True, False)
    finally:
        box[0].shutdown()
        box[0].server_close()
        th.join(timeout=60)
    assert not th.is_alive()


ENTRY_POINTS = ["info", "stats", "motion-extract", "flow-extract", "run-config", "run-batch",
                "bench-decode", "bench-e2e", "watch", "run_tracking_config",
                "run_detection_config", "run_watch"]


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_point_raises_without_cuda(entry, clip, monkeypatch):
    """With no device named every entry point takes the CUDA card, and
    raises where there is none (here: CUDA reported absent) rather than
    running on the CPU."""
    from ofps_torch.apps.detection import run_detection_config
    from ofps_torch.apps.tracking import run_tracking_config

    d, path, mvec, tracking = clip
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _write(d / "cfg.json", tracking)
    det = dict(tracking, app="detection", output={})
    calls = {
        "info": lambda: tcli.main(["info"]),
        "stats": lambda: tcli.main(["stats", str(d)]),
        "motion-extract": lambda: tcli.main(["motion-extract", path, str(d / "x.mvec")]),
        "flow-extract": lambda: tcli.main(["flow-extract", mvec, str(d / "x")]),
        "run-config": lambda: tcli.main(["run-config", cfg]),
        "run-batch": lambda: tcli.main(["run-batch", mvec]),
        "bench-decode": lambda: tcli.main(["bench-decode", mvec]),
        "bench-e2e": lambda: tcli.main(["bench-e2e", "--input", mvec]),
        "watch": lambda: tcli.main(["watch", cfg, "--port", "0"]),
        "run_tracking_config": lambda: run_tracking_config(tracking),
        "run_detection_config": lambda: run_detection_config(det),
        "run_watch": lambda: twatch.run_watch(tracking, port=0),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
