"""Typed, bounded, runtime-tunable plugin properties (port of
``ofps_tpu.core.properties``, which imports no JAX; the port keeps its own
copy).

Component parameters are immutable ``NamedTuple`` params objects, so
"setting a property" produces a new params value via ``_replace``.  This
module introspects any params NamedTuple into property descriptors and
validates and coerces values: unknown names and kind mismatches raise,
numbers clamp to the bounds declared in :data:`BOUNDS`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple


@dataclasses.dataclass
class PropertyDesc:
    """One exposed parameter: name, kind, current value, optional bounds."""

    name: str
    kind: str  # "bool" | "float" | "usize" | "str"
    value: Any
    bounds: Optional[Tuple[float, float]] = None


#: Optional (min, max) bounds per (component name, field).
BOUNDS: Dict[Tuple[str, str], Tuple[float, float]] = {
    # almeida estimator
    ("almeida", "num_iters"): (1, 500),
    ("almeida", "inlier_angle_deg"): (0.001, 10.0),
    ("almeida", "ransac_samples"): (10, 10000),
    # homography estimator
    ("homography", "desired_confidence"): (0.0, 1.0),
    ("homography", "max_error"): (0.00001, 0.1),
    ("homography", "max_iters"): (1, 5000),
    ("homography", "num_hypotheses"): (1, 4096),
    ("homography", "outlier_proba"): (0.0, 0.99),
    ("homography", "eval_cap"): (64, 65536),
    # multiview estimator
    ("multiview", "desired_confidence"): (0.0, 1.0),
    ("multiview", "max_error"): (0.00001, 0.1),
    ("multiview", "num_hypotheses"): (1, 4096),
    ("multiview", "outlier_proba"): (0.0, 0.99),
    ("multiview", "eval_cap"): (64, 65536),
    # libmv estimator
    ("libmv", "outlier_proba"): (0.0, 0.99),
    ("libmv", "max_error"): (0.00001, 0.1),
    ("libmv", "algo_points"): (7, 8),
    ("libmv", "num_hypotheses"): (1, 4096),
    ("libmv", "desired_confidence"): (0.0, 1.0),
    ("libmv", "eval_cap"): (64, 65536),
    # block_motion detector
    ("block_motion", "min_size"): (0.001, 1.0),
    ("block_motion", "subdivide"): (1, 16),
    ("block_motion", "target_motion"): (0.0001, 0.1),
}


def _kind_of(value: Any) -> str:
    if isinstance(value, bool):
        return "bool"
    if isinstance(value, int):
        return "usize"
    if isinstance(value, float):
        return "float"
    return "str"


def describe(component: str, params: NamedTuple) -> List[PropertyDesc]:
    """Property descriptors for a params NamedTuple."""
    out = []
    for name, value in params._asdict().items():
        out.append(
            PropertyDesc(
                name=name,
                kind=_kind_of(value),
                value=value,
                bounds=BOUNDS.get((component, name)),
            )
        )
    return out


def set_properties(
    component: str, params: NamedTuple, overrides: Dict[str, Any]
) -> NamedTuple:
    """Return new params with matching-kind overrides applied.

    Unknown names raise; kind mismatches raise; numeric values clamp to the
    declared bounds.
    """
    fields = params._asdict()
    new = {}
    for name, value in overrides.items():
        if name not in fields:
            raise KeyError(
                f"{component}: unknown property {name!r}; have {sorted(fields)}"
            )
        cur = fields[name]
        kind = _kind_of(cur)
        if kind == "bool":
            if not isinstance(value, bool):
                raise TypeError(f"{component}.{name}: expected bool, got {value!r}")
        elif kind == "usize":
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                raise TypeError(f"{component}.{name}: expected int, got {value!r}")
            value = int(value)
        elif kind == "float":
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                raise TypeError(f"{component}.{name}: expected float, got {value!r}")
            value = float(value)
        else:
            value = str(value)
        b = BOUNDS.get((component, name))
        if b is not None and kind in ("usize", "float"):
            value = min(max(value, b[0]), b[1])
            if kind == "usize":
                value = int(value)
        new[name] = value
    return params._replace(**new)
