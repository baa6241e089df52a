"""The estimator ms/frame table on the card (counterpart of the JAX
package's ``scripts/bench_estimators.py``, whose configurations and
reference numbers it keeps).

Each of the 8 estimator configurations runs on the reference's own
evaluation shape: a 150x84 synthetic-rotation field (12,600 vectors a
frame, the points within 0.71 of the screen centre valid), through the
serving path's graph machinery: a one-estimator ``StreamPipeline`` (no
detector) at B=1, ``step_from_flow`` (masked RANSAC) with the estimator's
carry threaded from step to step, its consumers replayed as one CUDA graph
per step on the card.  ``--iters`` chained steps per window, every output
in the checksum; each repeat builds a fresh pipeline (a graph's replay
time depends on its capture) whose first step, the capture, is untimed.
The table gives the best and the median repeat beside the reference's
Ryzen 9 3950X numbers (its docs/statistics/perf.csv, farneback row)::

    python -m ofps_torch.apps.bench_estimators [--device cuda|cpu]
        [--iters 30] [--repeats 3] [--out docs_stats/torch_h100/estimators_ms.md]

Prints one line per configuration, then one JSON line of the results.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
from pathlib import Path

import numpy as np
import torch

from ofps_torch.apps import gt as gtmod
from ofps_torch.apps import timing
from ofps_torch.apps.bench import step_checksum
from ofps_torch.apps.synthetic import euler_deg, get_grid, synthetic_field
from ofps_torch.core.camera import StandardCamera
from ofps_torch.core.motion import SparseFlow
from ofps_torch.device import resolve_device
from ofps_torch.estimators.base import create_estimator
from ofps_torch.parallel.stream import StreamPipeline

# Reference ms/frame on the Farneback 150x84 grid (the reference's
# docs/statistics/perf.csv, row "farneback"; BASELINE.md section 6).
REFERENCE_MS = {
    "almeida": 14.69,
    "almeida-ransac": 31.74,
    "homography-ransac": 5.57,
    "homography-lmeds": 9.93,
    "multiview-ransac": 287.56,
    "multiview-lmeds": 351.96,
    "libmv-7pt": 318.32,
    "libmv-8pt": 313.19,
}

CONFIGS = [
    ("almeida", "almeida", {"use_ransac": False}),
    ("almeida-ransac", "almeida", {}),
    ("homography-ransac", "homography", {}),
    ("homography-lmeds", "homography", {"use_ransac": False}),
    ("multiview-ransac", "multiview", {}),
    ("multiview-lmeds", "multiview", {"use_ransac": False}),
    ("libmv-7pt", "libmv", {"algo_points": 7}),
    ("libmv-8pt", "libmv", {"algo_points": 8}),
]

ITERS = 30
GW, GH = 150, 84
TRUTH_DEG = (0.3, -0.2, 0.5)
OUT = Path("docs_stats/torch_h100/estimators_ms.md")


def rotation_field(device):
    """(camera, the (1, 12600) :class:`SparseFlow` of the 150x84 grid under
    the ``TRUTH_DEG`` rotation, the true quaternion (4,) as numpy)."""
    cam = StandardCamera.create(GW / GH, 90.0)
    flow = synthetic_field(cam, euler_deg(*TRUTH_DEG), grid=get_grid(GW, GH, cam),
                           capacity=GW * GH, device=device)
    return cam, SparseFlow(*(x[None] for x in flow)), euler_deg(*TRUTH_DEG).numpy()


def error_deg(q: torch.Tensor, truth: np.ndarray) -> float:
    """Angle (deg) between an estimated delta rotation (4,) and the truth."""
    return math.degrees(gtmod._qangle(gtmod.rotation_to(q.cpu().numpy().astype(np.float64),
                                                        truth)))


def measure(name: str, props: dict, cam, flow: SparseFlow, iters: int = ITERS,
            repeats: int = 3, seed: int = 0) -> dict:
    """One configuration: per repeat a fresh pipeline, one untimed step (the
    capture), then one window of ``iters`` chained ``step_from_flow``
    steps; ``ms`` per frame of each window, its ``host_ms``, ``best``,
    ``median``, and the last step's delta rotation ``rot`` (4,)."""
    device = flow.mask.device
    ms, host = [], []
    for _ in range(repeats):
        pipe = StreamPipeline(cam, [create_estimator(name, **props)], None, device=device)
        state = pipe.init_state(1, GH, GW)
        gen = torch.Generator(device=device).manual_seed(seed)

        def chain(steps: int):
            nonlocal state, last
            acc = None
            for _ in range(steps):
                state, last = pipe.step_from_flow(state, flow, gen)
                s = step_checksum(last)
                acc = s if acc is None else acc + s
            return acc

        last = None
        chain(1).item()
        m, h, _ = timing.timed(lambda: chain(iters), device)
        ms.append(m / iters)
        host.append(h / iters)
        del pipe
    return {"ms": ms, "host_ms": host, "best": min(ms), "median": statistics.median(ms),
            "rot": last.delta_rot[0][0]}


def write_table(path: Path, rows: dict, device_desc: str, iters: int, repeats: int) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = [
        "# Estimator ms/frame on the card, against the reference",
        "",
        f"Device: **{device_desc}**.  Input: the 150x84 synthetic-rotation grid "
        "(12,600 vectors a frame), the reference's own evaluation shape.  Each "
        "configuration runs as a one-estimator `StreamPipeline` (no detector) at "
        "B=1 through `step_from_flow`, its consumers replayed as one CUDA graph per "
        f"step on the card; {iters} chained steps per window, {repeats} repeats, "
        "each a fresh pipeline and capture.  Reference column: Ryzen 9 3950X, the "
        "reference's docs/statistics/perf.csv (farneback row).  Written by "
        "`python -m ofps_torch.apps.bench_estimators`.",
        "",
        "| estimator | ofps_torch ms/frame (best) | median | host enqueue ms/frame | "
        "reference ms/frame | speedup (best) | rotation error, deg |",
        "|---|---|---|---|---|---|---|",
    ]
    for label, r in rows.items():
        ref = REFERENCE_MS[label]
        lines.append(f"| {label} | {r['best']:.3f} | {r['median']:.3f} | "
                     f"{min(r['host_ms']):.3f} | {ref:.2f} | {ref / r['best']:.1f}x | "
                     f"{r['err_deg']:.4f} |")
    path.write_text("\n".join(lines) + "\n")


def main(argv=None) -> int:
    from ofps_torch.apps.evaluate_matrix import device_line

    ap = argparse.ArgumentParser(prog="python -m ofps_torch.apps.bench_estimators",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cam, flow, truth = rotation_field(device)
    rows = {}
    for label, name, props in CONFIGS:
        r = measure(name, props, cam, flow, args.iters, max(1, args.repeats))
        r["err_deg"] = error_deg(r.pop("rot"), truth)
        rows[label] = r
        ref = REFERENCE_MS[label]
        print(f"{label:20s} {r['best']:8.3f} ms/frame (median {r['median']:.3f}, host "
              f"{min(r['host_ms']):.3f})   ref {ref:8.2f}   x{ref / r['best']:.1f}   "
              f"err {r['err_deg']:.4f} deg", flush=True)
    desc = device_line(device)
    write_table(args.out, rows, desc, args.iters, max(1, args.repeats))
    print(f"wrote {args.out}")
    print(json.dumps({"device": desc, "iters": args.iters, "estimators": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
