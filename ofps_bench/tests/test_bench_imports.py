"""Nothing the harness imports has the top-level name ``jax``, ``jaxlib``,
``flax``, ``ofps_tpu``, ``bench`` or ``chip_smoke``, and nothing the
reference imports has those or ``ofps_torch``.  Names are compared by the
part before the first dot, whole: ``ofps_torch`` begins with ``ofps_t`` and
is still not ``ofps_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from ofps_bench import run, spec

BENCH = spec.ROOT / "ofps_bench"
HARNESS_BANNED = {"jax", "jaxlib", "flax", "ofps_tpu", "bench", "chip_smoke"}
REFERENCE_BANNED = HARNESS_BANNED | {"ofps_torch"}


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    return [p for p in (BENCH / sub).rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


@pytest.mark.parametrize("where,banned", [("", HARNESS_BANNED), ("reference", REFERENCE_BANNED)])
def test_sources_import_nothing_banned(where, banned):
    found = {(p.name, m) for p in _sources(where) for m in _top_level_imports(p) if m in banned}
    assert not found
    assert len(_sources(where)) > 5


def test_the_banned_check_compares_whole_names():
    assert set(run.FORBIDDEN) == HARNESS_BANNED
    sys.modules.setdefault("ofps_tpux_probe", sys)  # a name that begins with a banned one
    try:
        assert "ofps_tpux_probe" not in run.forbidden_modules()
    finally:
        del sys.modules["ofps_tpux_probe"]


def _fresh(code: str) -> str:
    return subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                          text=True, check=True, timeout=300).stdout


def test_a_fresh_interpreter_loads_nothing_banned():
    mods = ["ofps_bench.run", "ofps_bench.serve", "ofps_bench.check", "ofps_bench.control",
            "ofps_bench.trace", "ofps_bench.roofline", "ofps_bench.inputs", "ofps_bench.spec",
            "ofps_torch.apps.batch", "ofps_torch.pipeline.runtime", "ofps_torch.parallel.stream"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from ofps_bench import spec\n"
            "for m in spec.load_benchmark()['per_layer']: spec.metric_reader(m['name'])\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    loaded = set(eval(_fresh(code)))
    assert not loaded & HARNESS_BANNED


def test_the_reference_alone_loads_no_program():
    code = ("import sys, importlib, pkgutil, ofps_bench.reference as r\n"
            "for m in pkgutil.iter_modules(r.__path__): importlib.import_module('ofps_bench.reference.' + m.name)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    loaded = set(eval(_fresh(code)))
    assert not loaded & REFERENCE_BANNED


@pytest.mark.parametrize("name", ["five_point", "multiview", "libmv"])
def test_the_frozen_estimator_copies_fall_under_the_reference_rule(name):
    """The copies of the port's five-point solver, multiview and libmv are
    among the sources the reference's rule reads, say which file they copy,
    and import only the reference."""
    path = BENCH / "reference" / f"{name}.py"
    assert path in _sources("reference")
    assert path.read_text().startswith("# Frozen copy of the port's plain ``ofps_torch/")
    mods = set(_top_level_imports(path))
    assert not mods & REFERENCE_BANNED
    assert "ofps_bench" in mods
