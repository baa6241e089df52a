"""Statistics aggregation (port of ``ofps_tpu.apps.stats``): collect the
per-estimator stats CSVs the tracking app exports and summarize mean
rotation errors (degrees) and mean per-stage times into one summary CSV.

Input layout: a directory of ``stats_<estimator>.csv`` files (the tracking
app's export) and optional ``perf.csv`` (PerfStats export); output: one
summary CSV with a row per estimator.
"""

from __future__ import annotations

import csv
import glob
import math
import os
from typing import Dict, List, Optional


def _mean(xs: List[float]) -> float:
    return sum(xs) / len(xs) if xs else float("nan")


def summarize_stats_dir(stats_dir: str, out_csv: Optional[str] = None):
    """Aggregate ``stats_*.csv`` files into per-estimator mean errors (deg)."""
    rows = []
    for path in sorted(glob.glob(os.path.join(stats_dir, "stats_*.csv"))):
        name = os.path.basename(path)[len("stats_") : -len(".csv")]
        errs: Dict[str, List[float]] = {
            "error": [],
            "error_r": [],
            "error_p": [],
            "error_y": [],
        }
        deltas: List[float] = []
        with open(path, newline="") as f:
            for rec in csv.DictReader(f):
                for k in errs:
                    if rec.get(k):
                        errs[k].append(float(rec[k]))
                if rec.get("delta"):
                    deltas.append(float(rec["delta"]))
        deg = 180.0 / math.pi
        rows.append(
            {
                "estimator": name,
                "frames": len(deltas),
                "avg_error_deg": _mean(errs["error"]) * deg,
                "avg_error_r_deg": _mean(errs["error_r"]) * deg,
                "avg_error_p_deg": _mean(errs["error_p"]) * deg,
                "avg_error_y_deg": _mean(errs["error_y"]) * deg,
                "avg_delta_deg": _mean(deltas) * deg,
            }
        )

    perf_path = os.path.join(stats_dir, "perf.csv")
    perf: Dict[str, float] = {}
    if os.path.exists(perf_path):
        with open(perf_path, newline="") as f:
            reader = csv.DictReader(f)
            cols: Dict[str, List[float]] = {
                k: [] for k in reader.fieldnames or [] if k != "frame"
            }
            for rec in reader:
                for k in cols:
                    if rec.get(k):
                        cols[k].append(float(rec[k]))
        perf = {f"avg_{k}_ms": _mean(v) for k, v in cols.items()}
    for row in rows:
        row.update(perf)

    if out_csv and rows:
        with open(out_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
    return rows
