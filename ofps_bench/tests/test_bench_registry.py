"""What a configuration names is found by name: the reference's estimators
and detectors by module, and the check numbers its ``limits`` name that the
harness does not compute itself by ``ofps_bench/checks/<key>.py``.  A limit
that nothing computes fails when the cell loads; a configuration without
estimators is judged without rotation numbers."""

import json
import sys
import types

import numpy as np
import pytest
import torch

import ofps_bench.reference as reference_pkg
from ofps_bench import check, inputs, run, spec
from ofps_bench.reference import det_base, est_base
from ofps_bench.reference.homography import refined_homography, rotation_candidates
from ofps_bench.reference.motion import SparseFlow
from ofps_bench.reference.step import Reference
from ofps_bench.tests import tiny

SEED = 2**31 + 77

PROBES = {
    "estimator": (est_base, "create_estimator", "est_base", "EstimatorInstance",
                  "init=lambda: (), estimate=None"),
    "detector": (det_base, "create_detector", "det_base", "DetectorInstance", "detect=None"),
}


def _probe_source(kind: str, name: str) -> str:
    _, _, base, record, fields = PROBES[kind]
    return (f"from ofps_bench.reference.{base} import {record}, register\n"
            f"@register({name!r})\n"
            f"def make(**kw):\n"
            f"    return {record}(name={name!r}, params=kw, {fields})\n")


@pytest.mark.parametrize("where", ["package_path", "sys_modules"])
@pytest.mark.parametrize("kind", list(PROBES))
def test_a_module_named_after_it_registers_it(tmp_path, monkeypatch, kind, where):
    base_mod, create, _, _, _ = PROBES[kind]
    name = f"probe_{kind}_{where}"
    module = f"ofps_bench.reference.{name}"
    monkeypatch.setattr(base_mod, "_REGISTRY", dict(base_mod._REGISTRY))
    monkeypatch.delitem(sys.modules, module, raising=False)
    if where == "package_path":  # a file beside the reference's, imported by name
        (tmp_path / f"{name}.py").write_text(_probe_source(kind, name))
        monkeypatch.setattr(reference_pkg, "__path__",
                            [*reference_pkg.__path__, str(tmp_path)])
    else:  # a module already in sys.modules, which registers when run
        mod = types.ModuleType(module)
        monkeypatch.setitem(sys.modules, module, mod)
    assert name not in base_mod._REGISTRY
    if where == "sys_modules":
        exec(_probe_source(kind, name), mod.__dict__)
    inst = getattr(base_mod, create)(name, width=3)
    assert inst.name == name and inst.params == {"width": 3}
    assert module in sys.modules


@pytest.mark.parametrize("kind", list(PROBES))
def test_an_unknown_name_says_where_it_looked(kind):
    base_mod, create, _, _, _ = PROBES[kind]
    with pytest.raises(KeyError) as err:
        getattr(base_mod, create)("no_such_thing")
    msg = str(err.value)
    assert "ofps_bench.reference.no_such_thing" in msg
    assert "registered" in msg


def test_the_built_in_names_resolve_by_module():
    for name in ("almeida", "homography", "multiview", "libmv"):
        assert est_base.create_estimator(name).name == name
    assert det_base.create_detector("block_motion").name == "block_motion"


def test_homography_families_hook_gives_the_two_families():
    """The hook is the code the check ran before it: the two decomposition
    families of the refined homography, bit for bit."""
    cfg = json.loads((spec.ROOT / "ofps_bench/configs/codec_track_1080p.json").read_text())
    tr = json.loads((spec.ROOT / "ofps_bench/traffic/codec_b8.json").read_text())
    cfg.update(width=320, height=176, capacity=512)
    cfg["camera"]["aspect"] = 320 / 176
    tr.update(streams=2, bank_frames=4)
    ref = Reference(cfg, "cpu")
    hom = ref.ests[1]
    assert hom.name == "homography" and ref.ests[0].families is None
    bank = inputs.codec_bank(SEED, 2, cfg, tr)
    rows = check._rows(bank, 1, cfg["capacity"], "cpu")
    flow = SparseFlow(rows[..., 0:2], rows[..., 2:4], rows[..., 4])
    draws = ref.draws(torch.Generator().manual_seed(SEED), 2, cfg["capacity"], dense=False)
    got = hom.families(flow, ref.camera, None, False, draws[1])
    h = refined_homography(None, hom.params, flow, ref.camera, max_error=None, dense=False,
                           fit_idx=draws[1])
    want, _ = rotation_candidates(h, ref.camera)
    assert got.shape == (2, 2, 4)
    assert torch.equal(got, want)
    consumed = ref.codec_step(rows, draws)
    assert consumed.families[0] is None and torch.equal(consumed.families[1], want)


# -- check files ---------------------------------------------------------------

CHECK_FILE = """
def number(cell, seed, served, ref, checked):
    # the steps checked, and the program's whole result is there to read
    assert served.outputs["result"].estimator_names == [e.name for e in ref.ests]
    return float(len(checked))
"""


@pytest.fixture
def root(tmp_path):
    return tiny.make_root(tmp_path)


def _with_limit(root, config: str, key: str, limit: float) -> None:
    path = root / f"ofps_bench/configs/{config}.json"
    cfg = json.loads(path.read_text())
    cfg["limits"][key] = limit
    path.write_text(json.dumps(cfg))


@pytest.mark.parametrize("limit", [100.0, 1.0])
def test_a_check_file_is_found_and_judged(root, limit):
    (root / "ofps_bench/checks").mkdir()
    (root / "ofps_bench/checks/steps_checked.py").write_text(CHECK_FILE)
    _with_limit(root, "codec_tiny", "steps_checked", limit)
    cell = spec.load_cell("codec_tiny.b2", root)
    assert check.file_limits(cell.config, root) == ["steps_checked"]
    out = run.run_cell(cell, SEED, 1.0, False, "cpu", 0.0)
    c = out["checks"]["steps_checked"]
    assert c == {"value": 1.0 + cell.traffic["check_steps"], "limit": limit}
    assert out["correct"] is (limit == 100.0), out["checks"]


def test_a_limit_that_nothing_computes_fails_when_the_cell_loads(root):
    _with_limit(root, "codec_tiny", "translation_deg", 0.001)
    with pytest.raises(ValueError, match="translation_deg"):
        spec.load_cell("codec_tiny.b2", root)


# -- configurations without estimators ----------------------------------------


def test_a_detection_only_config_has_no_rotation_limits(root):
    name = tiny.add_cell(root, "codec_detect_tiny.b2", "codec_tiny", "codec_tiny",
                         estimators=[], limits={"vectors_off": 0, "det_off": 0,
                                                "delta_deg": 0.001})
    with pytest.raises(ValueError, match="delta_deg"):
        spec.load_cell(name, root)


def test_codec_numbers_without_estimators(root):
    """``run_batch`` runs almeida when given no estimators, so the codec
    path is judged here on outputs made by hand: the reference's verdicts
    and the bank's vector counts, then one verdict flipped."""
    name = tiny.add_cell(root, "codec_detect_tiny.b2", "codec_tiny", "codec_tiny",
                         estimators=[], limits={"vectors_off": 0, "det_off": 0})
    cell = spec.load_cell(name, root)
    cfg, b = cell.config, cell.traffic["streams"]
    cap = cfg["capacity"]
    bank = inputs.codec_bank(SEED, b, cfg, cell.traffic)
    ref = Reference(cfg, "cpu")
    assert ref.ests == [] and ref.draws(None, b, cap, dense=False) == []
    steps = 4
    detected = np.stack([ref.codec_step(check._rows(bank, t, cap, "cpu"), []).detected.numpy()
                         for t in range(steps)])
    vectors = np.array([[min(len(bank.pos[s][t]), cap) for s in range(b)] for t in range(steps)])
    out = {"bank": bank, "rot": [], "delta": [], "detected": detected, "vectors": vectors}
    nums = check.codec_numbers(cell, SEED, out, range(1, steps), ref, [0, 2, 3])
    assert nums == {"vectors_off": 0.0, "det_off": 0.0}
    assert check.passed(check.judge(nums, cfg["limits"]))
    detected[2, 1] = ~detected[2, 1]
    nums = check.codec_numbers(cell, SEED, out, range(1, steps), ref, [0, 2, 3])
    assert nums["det_off"] == 1.0


def test_frames_without_estimators_runs_and_is_judged(root):
    """The frames path serves a detection-only pipeline: no rotation
    numbers, and the grid, warm start and verdicts still judged."""
    name = tiny.add_cell(root, "frames_detect_tiny.b2", "frames_tiny", "frames_tiny",
                         estimators=[], limits={"det_off": 0, "grid_off": 0.01,
                                                "warm_off": 0.02})
    cell = spec.load_cell(name, root)
    out = run.run_cell(cell, SEED, 3.0, False, "cpu", 0.0)
    assert set(out["checks"]) == {"det_off", "grid_off", "warm_off"}
    assert out["correct"], out["checks"]
    served = out["served"]
    assert served.outputs["rot"] == [] and served.failed == 0
    assert len(served.outputs["result"]) == len(served.outputs["detected"])
