"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs[].file``) and a traffic mix
(``ofps_bench/traffic/<traffic>.json``); a per-layer metric is read by
``ofps_bench/metrics/<name>.py``; a check number that the harness does not
compute itself is computed by ``ofps_bench/checks/<key>.py``, named by a
key of the configuration's ``limits``.  Adding a cell, a configuration, a
mix, a metric or a check number is adding files and entries: nothing here
lists them.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Optional

ROOT = Path(__file__).resolve().parent.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]  # the metrics this cell reports
    per_layer: List[Dict[str, Any]]
    root: Path  # the tree the cell was found in


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic mix and metrics."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "ofps_bench" / "traffic" / f"{w['traffic']}.json").read_text())
    if traffic["input"] != config["input"]:
        raise ValueError(f"{name}: traffic {w['traffic']!r} feeds {traffic['input']!r}, "
                         f"config {w['config']!r} takes {config['input']!r}")
    from ofps_bench import check

    check.file_limits(config, root)  # every limit is computed by something
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=root,
    )


def _load(path: Path, module: str):
    """The module of the file ``path`` (a name may hold dots, so it is
    loaded by path)."""
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT) -> Callable[[Any], Optional[float]]:
    """``read(record)`` of ``ofps_bench/metrics/<name>.py``."""
    return _load(root / "ofps_bench" / "metrics" / f"{name}.py", f"ofps_bench_metric_{name}").read


def check_path(key: str, root: Path = ROOT) -> Path:
    return root / "ofps_bench" / "checks" / f"{key}.py"


def check_number(key: str, root: Path = ROOT) -> Callable[..., float]:
    """``number(cell, seed, served, ref, checked)`` of
    ``ofps_bench/checks/<key>.py``."""
    return _load(check_path(key, root), f"ofps_bench_check_{key}").number
