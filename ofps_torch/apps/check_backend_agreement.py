"""Card-vs-CPU agreement of representative evaluation-matrix cells
(counterpart of the JAX package's ``scripts/check_backend_agreement.py``,
whose cells, clips and tolerance it keeps).

Precision can leak on the card alone: on the TPU an unguarded bf16 matmul
cost multiview 0.35 deg/frame while the CPU tests stayed green, and TF32
plays that part on the H100 (``ofps_torch.device`` refuses it).  This
measures the property on the card: each (estimator, clip) cell of the
gt-mv source (exact synthetic fields, ``apps.synthetic``, on
``evaluate_matrix.make_schedules``' clips 0 and 5) runs through the
serving path (``evaluate_matrix.make_pipeline``: a one-estimator
``StreamPipeline``, ``step_from_flow``, the consumers' CUDA graph on the
card) on ``--device`` and on the CPU, in one process, and the mean
rotation errors (deg/frame) must agree within ``TOL_DEG``.

Both sides take the same inputs and the same RANSAC draws: the draws are
made on the CPU from one seeded generator and passed to both, so the check
compares two backends, not two random-number generators.  The residual is
float32 numerics (reduction order, fused multiply-adds); an algorithm
that diverges between backends lands orders of magnitude above it::

    python -m ofps_torch.apps.check_backend_agreement [--device cuda|cpu]

Prints one line per cell and one JSON line; exits nonzero on any
disagreement.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ofps_torch.apps import evaluate_matrix as em
from ofps_torch.device import resolve_device

# (estimator factory name, props, label): the evaluation matrix's labels.
CELLS = [
    ("almeida", {}, "almeida-ransac"),
    ("homography", {}, "homography-ransac"),
    ("multiview", {}, "multiview-ransac"),
    ("libmv", {"algo_points": 7}, "libmv-7pt"),
    ("libmv", {"algo_points": 8}, "libmv-8pt"),
]
CLIPS = (0, 5)
TOL_DEG = 0.01


def run_cells(device, cells=CELLS, clips=CLIPS) -> dict:
    """{"<label>/clip<c>": {"device": deg/frame, "cpu": deg/frame, "diff"}}:
    every cell on ``device`` and on the CPU, the clips as one batch, with
    the same fields and the same draws (made on the CPU from
    ``evaluate_matrix.SEED``)."""
    device = resolve_device(device)
    cpu = torch.device("cpu")
    cam, schedules = em.camera(), em.make_schedules()
    per_clip = [em.gt_fields(cam, schedules[ci]) for ci in clips]
    flows = {d: em.stack_fields(per_clip, d) for d in {device, cpu}}
    truths = [em._truth_quats(schedules[ci]) for ci in clips]
    n = flows[cpu].capacity
    out = {}
    for _name, _props, label in cells:
        errs = {}
        for where, dev in (("device", device), ("cpu", cpu)):
            pipe = em.make_pipeline(label, cam, dev)
            est = pipe.estimators[0]
            gen = torch.Generator().manual_seed(em.SEED)
            draws = [(_to(est.draw(gen, (len(clips),), n, cpu, dense=False), dev),)
                     for _ in range(em.T)]
            rots, _ = em.run_config(pipe, flows[dev], draws=draws)
            errs[where] = em.mean_errors_deg(rots, truths)
        for ci, e_dev, e_cpu in zip(clips, errs["device"], errs["cpu"]):
            out[f"{label}/clip{ci}"] = {"device": e_dev, "cpu": e_cpu, "diff": abs(e_dev - e_cpu)}
    return out


def _to(x, device):
    """A draw (a tensor or a tuple of tensors) on ``device``."""
    return x.to(device) if isinstance(x, torch.Tensor) else tuple(t.to(device) for t in x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ofps_torch.apps.check_backend_agreement",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cells = run_cells(device)
    bad = []
    for cell, r in cells.items():
        ok = r["diff"] <= TOL_DEG
        print(f"{cell:24s} {device.type}={r['device']:8.4f} cpu={r['cpu']:8.4f} "
              f"|d|={r['diff']:.2e}  {'ok' if ok else 'DISAGREE'}", flush=True)
        if not ok:
            bad.append(cell)
    print(json.dumps({"device": em.device_line(device), "tol_deg": TOL_DEG, "cells": cells,
                      "disagree": bad}))
    if bad:
        print(f"FAIL: backend disagreement on {bad}", file=sys.stderr)
        return 1
    print("backend agreement OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
