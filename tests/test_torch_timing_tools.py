"""The port's timing tools (``ofps_torch.apps.{bench_estimators,
profile_pipeline, profile_libmv, perf_lab, check_backend_agreement}``)
against the JAX package's ``scripts/`` of the same names, on the CPU at
small sizes.

* ``bench_estimators``: the same 8 configurations and reference numbers as
  JAX's; at 2 iterations it writes 8 rows to ``--out`` and leaves
  ``PARITY_BENCH.md``'s bytes as they were; almeida without RANSAC equals
  JAX's ``estimate`` on the same 150x84 field within 1e-5; every RANSAC
  configuration lies within 0.05 deg of the true rotation.
* ``profile_pipeline`` and ``profile_libmv``: every stage of JAX's, under
  its label (read from JAX's source), runs on the CPU at a tiny size; the
  ``step`` stage gives a ``StreamPipeline`` step's checksum and
  ``whole_step`` ``estimate_libmv``'s outputs.
* ``perf_lab``: ``base``, ``cold``, ``parts`` (one row per pyramid level)
  and ``ablate`` (JAX's five variants) run; ``blocks`` is refused (the
  port has no block-shape knob).
* ``check_backend_agreement``: the same cells, clips and tolerance as
  JAX's; on the CPU against the CPU it returns 0; almeida-RANSAC on clip 0
  agrees with JAX's ``run_cells`` within ``TOL_DEG``.

JAX's runs are module fixtures.
"""

import importlib.util
import json
import re
import sys
from contextlib import redirect_stdout
from io import StringIO
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ofps_torch.apps import bench as tbench
from ofps_torch.apps import bench_estimators as tbe
from ofps_torch.apps import check_backend_agreement as tcba
from ofps_torch.apps import perf_lab as tpl
from ofps_torch.apps import profile_libmv as tplm
from ofps_torch.apps import profile_pipeline as tpp
from ofps_torch.core.camera import StandardCamera as TCam
from ofps_torch.detectors.base import create_detector as t_det
from ofps_torch.estimators.base import create_estimator as t_est
from ofps_torch.estimators.libmv import LibmvParams, PrevMotion, estimate_libmv, hypothesis_count
from ofps_torch.parallel.stream import StreamPipeline as TPipe
from ofps_tpu.core.camera import StandardCamera as JCam
from ofps_tpu.estimators.base import create_estimator as j_est
from synthetic import euler_deg as j_euler, get_grid as j_grid, synthetic_field as j_field
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TINY = ["--device", "cpu", "--iters", "2", "--repeats", "1"]
TRUTH_DEG = 0.05


def _jax_script(name):
    """A module of the JAX package's ``scripts/<name>.py`` (its main not run)."""
    sys.path.insert(0, str(ROOT / "scripts"))
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_tail(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _labels(script: str, call: str):
    """The stage labels that a JAX script passes to ``call("label", ...``."""
    src = (ROOT / "scripts" / script).read_text()
    return re.findall(rf'{call}\(\s*"([a-z0-9_]+)"', src)


@pytest.fixture(scope="module")
def estimators_run(tmp_path_factory):
    """(the JSON line, the table's text) of a 2-iteration run on the CPU."""
    out = tmp_path_factory.mktemp("est") / "estimators_ms.md"
    parity = (ROOT / "PARITY_BENCH.md").read_bytes()
    with redirect_stdout(StringIO()) as said:
        assert tbe.main([*TINY, "--out", str(out)]) == 0
    assert (ROOT / "PARITY_BENCH.md").read_bytes() == parity
    return json.loads(said.getvalue().strip().splitlines()[-1]), out.read_text()


def test_bench_estimators_configs_are_jax_s():
    jbe = _jax_script("bench_estimators")
    assert tbe.CONFIGS == jbe.CONFIGS and tbe.REFERENCE_MS == jbe.REFERENCE_MS
    assert tbe.ITERS == jbe.ITERS


def test_bench_estimators_table(estimators_run):
    rec, table = estimators_run
    rows = [line for line in table.splitlines() if line.startswith("| ") and "---" not in line]
    assert [r.split(" | ")[0][2:] for r in rows[1:]] == [c[0] for c in tbe.CONFIGS]
    assert "Ryzen 9 3950X" in table and "cpu" in table
    for label, r in rec["estimators"].items():
        assert np.isfinite(r["best"]) and r["best"] > 0
        assert r["err_deg"] < TRUTH_DEG, (label, r["err_deg"])


def test_bench_estimators_almeida_matches_jax():
    cam, flow, _ = tbe.rotation_field(CPU)
    got = tbe.measure("almeida", {"use_ransac": False}, cam, flow, iters=1, repeats=1)["rot"]
    jcam = JCam.create(150.0 / 84.0, 90.0)
    jflow = j_field(jcam, j_euler(*tbe.TRUTH_DEG), grid=j_grid(150, 84, jcam), capacity=150 * 84)
    ref, _, _ = j_est("almeida", use_ransac=False).estimate((), jflow, jcam, jax.random.PRNGKey(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_profile_pipeline_stages(capsys):
    # JAX's stage("name", ...) and _hom_fit_stage("name", ...) calls.
    assert set(tpp.STAGES) == set(_labels("profile_pipeline.py", "stage"))
    assert tpp.main([*TINY, "--height", "96", "--width", "128"]) == 0
    rec = _json_tail(capsys)
    assert rec["unit"] == "us/step" and rec["batch"] == 1
    assert all(np.isfinite(rec[s]) and rec[s] > 0 for s in tpp.STAGES)
    assert set(rec["device_us"]) == set(tpp.STAGES)


def test_profile_pipeline_step_is_a_pipeline_step():
    b, h, w = 1, 96, 128
    fn, st0 = tpp.build_stages(b, h, w, CPU)["step"]
    _, got = fn(st0, 0)
    pipe = TPipe(TCam.create(w / h, 90.0), [t_est("almeida"), t_est("homography")],
                 t_det("block_motion"), emit_dense_flow=False, device=CPU)
    _, out = pipe.step_from_frames(pipe.init_state(b, h, w), tbench.make_inputs(b, h, w, CPU)[1],
                                   torch.Generator().manual_seed(4))
    assert got.item() == tbench.step_checksum(out).item()


def test_profile_libmv_stages(capsys):
    assert tplm.LABELS == tuple(_labels("profile_libmv.py", "timed"))
    assert tplm.ITERS == 48
    assert tplm.main(TINY) == 0
    rec = _json_tail(capsys)
    assert list(rec["stages"]) == list(tplm.LABELS)
    assert all(np.isfinite(r["best"]) and r["best"] > 0 for r in rec["stages"].values())


def test_profile_libmv_whole_step_is_estimate_libmv():
    got = tplm.build_stages(CPU)["whole_step"](0)
    cam, flow, _ = tbe.rotation_field(CPU)
    params = LibmvParams()
    gen = torch.Generator().manual_seed(0)
    shape = (1, hypothesis_count(params), params.algo_points)
    draws = (torch.rand(shape, generator=gen), torch.rand(shape, generator=gen))
    empty = PrevMotion(*(x[None] for x in PrevMotion.empty()))
    ref = estimate_libmv(params, empty, flow, cam, draws)
    for a, b in zip((got[0], got[1], *got[2]), (ref[0], ref[1], *ref[2])):
        assert torch.equal(a, b)


def test_perf_lab_modes(capsys):
    assert tpl.main(["base", "cold", "parts", "ablate", *TINY, "--batch", "2",
                     "--ablate-iters", "2", "--height", "96", "--width", "128"]) == 0
    rec = _json_tail(capsys)
    assert {"base", "cold", "parts", "ablate"} <= set(rec)
    assert len(rec["parts"]) == 3  # 96x128: three pyramid levels
    assert [name for name, _ in tpl.ABLATE] == list(rec["ablate"])
    assert all(v["fps_best"] > 0 for v in rec["ablate"].values())
    with pytest.raises(SystemExit):
        tpl.main(["blocks", "--device", "cpu"])


def test_perf_lab_defaults_are_jax_s():
    """JAX's PERF_B / PERF_ITERS defaults (16, 6) as flags, base by default."""
    jpl = (ROOT / "scripts" / "perf_lab.py").read_text()
    assert 'os.environ.get("PERF_B", "16")' in jpl and 'os.environ.get("PERF_ITERS", "6")' in jpl
    args = tpl.parse_args([])
    assert (args.batch, args.iters, args.modes) == (16, 6, ["base"])


@pytest.fixture(scope="module")
def jax_alm_cell():
    jcba = _jax_script("check_backend_agreement")
    jcba.CELLS = [c for c in jcba.CELLS if c[2] == "almeida-ransac"]
    jcba.CLIPS = (0,)
    return jcba.run_cells()["cells"]["almeida-ransac/clip0"]


def test_check_backend_agreement_cells_are_jax_s():
    jcba = _jax_script("check_backend_agreement")
    assert tcba.CELLS == jcba.CELLS and tcba.CLIPS == jcba.CLIPS and tcba.TOL_DEG == jcba.TOL_DEG


def test_check_backend_agreement_cpu_returns_0(capsys):
    assert tcba.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-2])
    assert rec["disagree"] == [] and lines[-1] == "backend agreement OK"
    assert sorted(rec["cells"]) == sorted(f"{c[2]}/clip{ci}" for c in tcba.CELLS
                                          for ci in tcba.CLIPS)


def test_check_backend_agreement_matches_jax(jax_alm_cell):
    cell = tcba.run_cells(CPU, cells=[c for c in tcba.CELLS if c[2] == "almeida-ransac"],
                          clips=(0,))["almeida-ransac/clip0"]
    assert abs(cell["device"] - jax_alm_cell) <= tcba.TOL_DEG
    assert cell["diff"] == 0.0
