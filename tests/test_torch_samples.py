"""The port's sample generator (``python -m ofps_torch.apps.samples``) and
BASELINE's sample configs through the port's ``run-config``, against the
JAX package's ``samples/make_samples.py`` parts and apps on the CPU.

* The ``.mvec`` rotation stream against JAX's ``make_rotation_stream``
  (imported, never its ``main()``, which rewrites ``samples/*.json``):
  equal frame and vector counts, positions and motions within 1e-6 (float32
  rounding of the two frameworks' projections), the GT CSV's header equal
  and its values within 1e-6.
* ``detect.avi`` byte-equal to JAX's ``encode_test_video``.
* ``run-config`` on the two tracking configs against JAX's
  ``run_tracking_config`` on the same configs: stats CSV headers and rows
  equal in number; almeida under 1e-4 deg/frame; every estimator under
  0.01 and within 0.005 of JAX's mean (the RANSAC draws differ between the
  packages: the largest gap measured on the CPU was 0.0018).
* ``basic_detect``'s ranges equal to JAX's and to ``chip_smoke.py``'s
  constant, which the card is held to on the committed
  ``ofps_torch/eval_data/detect.mvec``; that file rebuilt byte for byte by
  the port's ``motion-extract``.
* ``samples/*.json`` unchanged by the generator, which writes into its
  output directory only.

JAX's runs are module fixtures, once each (its four-estimator tracking
run takes most of the file's time).  The CCTV clip and its config are in
``test_torch_cctv_scenario.py`` (slow).
"""

import csv
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from ofps_torch.apps import cli as tcli
from ofps_torch.apps import samples as tsam
from ofps_torch.decoders.av import encode_test_video as t_encode
from ofps_torch.decoders.mvec import read_mvec_frame
from ofps_tpu.apps.detection import run_detection_config as j_detection
from ofps_tpu.apps.tracking import run_tracking_config as j_tracking
from ofps_tpu.core.camera import StandardCamera as JCam
from ofps_tpu.decoders.av import encode_test_video as j_encode
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from samples.make_samples import make_rotation_stream as j_rotation_stream  # noqa: E402

CPU = ["--device", "cpu"]
TRACKING = ("synthetic_almeida_gt.json", "synthetic_all_gt.json")
ALMEIDA_DEG = 1e-4
EST_DEG = 0.01
VS_JAX_DEG = 0.005


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frames(path):
    with open(path, "rb") as f:
        out = []
        while (rec := read_mvec_frame(f)) is not None:
            out.append(rec)
    return out


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _mean_err_deg(rows):
    """Mean of a stats CSV's per-frame ``error`` column (radians), deg."""
    col = rows[0].index("error")
    errs = [float(r[col]) for r in rows[1:] if r[col]]
    return math.degrees(sum(errs) / len(errs))


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    """The generator's ``--no-video`` output and ``detect.avi`` with
    ``basic_detect.json`` beside it (the CCTV clip, 3,600 frames, is left
    to the slow test), with ``samples/*.json``'s bytes before it ran."""
    before = {p.name: p.read_bytes() for p in (ROOT / "samples").glob("*.json")}
    out = tmp_path_factory.mktemp("samples")
    assert tsam.main([str(out), "--no-video"]) == 0
    written = sorted(p.name for p in out.iterdir())
    cfg = tsam.sample_configs(str(out))["basic_detect.json"]
    t_encode(cfg["decoder"]["input"], **tsam.DETECT_CLIP)
    (out / "basic_detect.json").write_text(json.dumps(cfg))
    return out, before, written


def _jax_config(out, name, sub):
    """``name``'s config with its outputs moved into ``out/sub``."""
    cfg = json.loads((out / name).read_text())
    (out / sub).mkdir(exist_ok=True)
    for k, v in cfg["output"].items():
        cfg["output"][k] = str(out / sub / os.path.basename(v))
    return cfg


@pytest.fixture(scope="module")
def jax_tracking(samples):
    """JAX's ``run_tracking_config`` on both tracking configs: each
    estimator's stats CSV rows, by config."""
    out = samples[0]
    res = {}
    for name in TRACKING:
        cfg = _jax_config(out, name, "jax")
        j_tracking(cfg)
        prefix = cfg["output"]["stats_csv_prefix"]
        res[name] = {e["name"]: _rows(prefix + e["name"] + ".csv") for e in cfg["estimators"]}
    return res


def test_rotation_stream_matches_jax(samples, tmp_path):
    out = samples[0]
    j_mvec, j_gt = tmp_path / "j.mvec", tmp_path / "j_gt.csv"
    j_rotation_stream(str(j_mvec), str(j_gt), tsam.DELTAS_DEG, JCam.create(1.0, 90.0))
    got, ref = _frames(out / "synthetic_rot.mvec"), _frames(j_mvec)
    assert len(got) == len(ref) == len(tsam.DELTAS_DEG) + 1
    assert [len(p) for p, _ in got] == [len(p) for p, _ in ref]
    assert len(got[0][0]) == 0 and all(len(p) > 1000 for p, _ in got[1:])
    for (gp, gm), (rp, rm) in zip(got, ref):
        np.testing.assert_allclose(gp, rp, rtol=0, atol=1e-6)
        np.testing.assert_allclose(gm, rm, rtol=0, atol=1e-6)
    g_rows, r_rows = _rows(out / "synthetic_rot_gt.csv"), _rows(j_gt)
    assert g_rows[0] == r_rows[0] and len(g_rows) == len(r_rows) == len(got) + 1
    np.testing.assert_allclose(np.float64(g_rows[1:]), np.float64(r_rows[1:]), rtol=0, atol=1e-6)


def test_detect_clip_is_jax_bytes(samples, tmp_path):
    out = samples[0]
    j_encode(str(tmp_path / "detect.avi"), **tsam.DETECT_CLIP)
    assert (out / "detect.avi").read_bytes() == (tmp_path / "detect.avi").read_bytes()


@pytest.mark.parametrize("name", TRACKING)
def test_tracking_config_matches_jax(name, samples, jax_tracking, capsys):
    out = samples[0]
    assert tcli.main(CPU + ["run-config", str(out / name)]) == 0
    said = capsys.readouterr().out
    cfg = json.loads((out / name).read_text())
    names = [e["name"] for e in cfg["estimators"]]
    assert f"processed {len(tsam.DELTAS_DEG) + 1} frames with {names}" in said
    assert "estimate: avg" in said and "eager runs" in said
    for est in names:
        rows = _rows(cfg["output"]["stats_csv_prefix"] + est + ".csv")
        ref = jax_tracking[name][est]
        assert rows[0] == ref[0] and len(rows) == len(ref) == len(tsam.DELTAS_DEG) + 2
        got_deg, ref_deg = _mean_err_deg(rows), _mean_err_deg(ref)
        assert got_deg < (ALMEIDA_DEG if est == "almeida" else EST_DEG), (est, got_deg)
        assert abs(got_deg - ref_deg) <= VS_JAX_DEG, (est, got_deg, ref_deg)


def test_basic_detect_matches_jax_and_the_committed_vectors(samples, tmp_path, capsys):
    out = samples[0]
    want = _chip_smoke().SAMPLES_DETECT_RANGES
    assert tcli.main(CPU + ["run-config", str(out / "basic_detect.json")]) == 0
    assert f"processed 30 frames; motion ranges: {want}" in capsys.readouterr().out
    cfg = _jax_config(out, "basic_detect.json", "jax_det")
    s = cfg["settings"]
    ranges = j_detection(cfg).filtered_ranges(s["max_frame_gap"], s["min_frames"])
    assert ranges == want
    assert (out / "ranges.csv").read_text() == Path(cfg["output"]["ranges_csv"]).read_text()

    # The committed .mvec is the port's motion-extract of detect.avi, and
    # detection on it gives the clip's ranges.
    mvec = tmp_path / "detect.mvec"
    assert tcli.main(CPU + ["motion-extract", str(out / "detect.avi"), str(mvec)]) == 0
    assert mvec.read_bytes() == (ROOT / "ofps_torch" / "eval_data" / "detect.mvec").read_bytes()
    det = dict(json.loads((out / "basic_detect.json").read_text()),
               decoder={"input": str(mvec)}, output={})
    (tmp_path / "det.json").write_text(json.dumps(det))
    capsys.readouterr()
    assert tcli.main(CPU + ["run-config", str(tmp_path / "det.json")]) == 0
    assert f"motion ranges: {want}" in capsys.readouterr().out


def test_generator_writes_only_its_outdir(samples):
    out, before, written = samples
    assert written == ["synthetic_all_gt.json", "synthetic_almeida_gt.json",
                       "synthetic_rot.mvec", "synthetic_rot_gt.csv"]

    def paths(cfg):
        return [cfg["decoder"]["input"], cfg.get("ground_truth", str(out / "-")),
                *cfg["output"].values()]

    def rest(cfg):
        return {k: v for k, v in cfg.items() if k not in ("decoder", "ground_truth", "output")}

    # Each config is JAX's file but for its paths, which are in OUTDIR.
    for name, cfg in tsam.sample_configs(str(out)).items():
        assert all(p.startswith(str(out) + os.sep) for p in paths(cfg)), name
        assert rest(cfg) == rest(json.loads(before[name])), name
        assert sorted(cfg["output"]) == sorted(json.loads(before[name])["output"]), name
    for name in TRACKING:
        assert json.loads((out / name).read_text()) == tsam.sample_configs(str(out))[name]
    assert {p.name: p.read_bytes() for p in (ROOT / "samples").glob("*.json")} == before
