"""Per-stage cost of the serving step on the card (counterpart of the JAX
package's ``scripts/profile_pipeline.py``, whose stages and names it keeps).

Each stage is a function chained ``--iters`` times (its real carry, such
as the warm flow, threaded through) after one untimed warm-up call:

  flow        dense pyramid flow at 1080p, the warm start carried
  densify     the unfused ``grid_downsample_uv`` 1080p -> 150x84
  almeida     the full almeida-RANSAC estimate on the 150x84 grid
  alm_sample  almeida's RANSAC draws alone
  alm_fits    the minimal 3-point fits on drawn samples (no scoring)
  alm_refit   one full-N weighted LSQ refit alone
  homography  the full homography estimate on the grid
  hom_fit     homography's robust_fit with its LO refits
  hom_fit0    the same without them
  detector    block-motion detect on the grid (the sparse path)
  det_densify the detector's scatter-mean densify alone
  det_label   its largest-component labelling alone
  step        the complete StreamPipeline step (the reference total)

The RANSAC stages take their draws from a bank made before the window
(``alm_sample`` times the drawing), so that they can be captured.  Per
stage: the CUDA-event time per call (best and median of ``--repeats``
windows, with the host's enqueue time) and, where the stage can be
captured, its device-only time from a CUDA graph of 5 chained calls
(``alm_sample`` draws from a ``torch.Generator`` and ``step`` replays its
own graph, so neither is captured)::

    python -m ofps_torch.apps.profile_pipeline [--device cuda|cpu]
        [--batch 1] [--iters 96] [--repeats 3] [--stages flow,step]
        [--height 1080] [--width 1920]

Prints one line per stage on stderr, then one JSON line: microseconds per
call (a call is one step of B streams) per stage, and ``device_us``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ofps_torch.apps import timing
from ofps_torch.apps.bench import make_inputs, step_checksum
from ofps_torch.core.camera import StandardCamera
from ofps_torch.core.motion import Densifier, field_to_sparse, grid_downsample_uv, grid_size_for
from ofps_torch.detectors.base import create_detector
from ofps_torch.detectors.block_motion import block_dim
from ofps_torch.device import resolve_device
from ofps_torch.estimators.almeida import AlmeidaParams, solve_ypr_ransac, solve_ypr_weighted
from ofps_torch.estimators.base import create_estimator
from ofps_torch.estimators.homography import HomographyParams, _minimal, hypothesis_count
from ofps_torch.kernels.almeida import _take
from ofps_torch.ops.components import largest_component
from ofps_torch.ops.flow_pyramid import FlowParams, dense_flow_warm
from ofps_torch.ops.homography import dlt_homography, homography_transfer_error
from ofps_torch.ops.robust import draw_dense, robust_fit
from ofps_torch.parallel.stream import StreamPipeline

STAGES = ("flow", "densify", "almeida", "alm_sample", "alm_fits", "alm_refit", "homography",
          "hom_fit", "hom_fit0", "detector", "det_densify", "det_label", "step")
NOT_CAPTURED = ("alm_sample", "step")
DRAW_BANK = 8  # draws made ahead per RANSAC stage, taken in turn
# Calls in a device-only graph: an estimator call is ~10^4 kernels.
GRAPH_CALLS = 5


def build_stages(batch: int, h: int, w: int, device):
    """{name: (fn(carry, i) -> (carry, 0-d checksum), carry0)} of every
    stage at (batch, h, w) on ``device``."""
    gw, gh = grid_size_for(w, h)
    n = gw * gh
    camera = StandardCamera.create(w / h, 90.0)
    i1, i2 = make_inputs(batch, h, w, device)
    g = torch.Generator().manual_seed(2)
    u0 = (torch.rand((batch, h, w), generator=g) * 6.0 - 3.0).to(device)
    v0 = torch.roll(u0, 1, dims=-1)
    sparse = field_to_sparse(grid_downsample_uv(u0, v0, gw, gh, norm_wh=(w, h)))
    params, alm, hp = FlowParams(), AlmeidaParams(), HomographyParams()
    gen = torch.Generator(device=device).manual_seed(3)

    def bank(rows: int, k: int):
        return [draw_dense(gen, (batch,), n, rows, k, device) for _ in range(DRAW_BANK)]

    alm_draws, hom_draws = bank(alm.num_iters, 3), bank(hypothesis_count(hp), 4)
    stages = {}

    def flow_fn(warm, i):
        (u, v), warm, _ = dense_flow_warm(i1, i2, params, warm=warm)
        return warm, u.sum() + v.sum()

    stages["flow"] = (flow_fn, dense_flow_warm(i1, i2, params)[1])
    stages["densify"] = (
        lambda c, i: (c, grid_downsample_uv(u0, v0, gw, gh, norm_wh=(w, h)).sum()), None)

    def alm_fn(c, i):
        q = solve_ypr_ransac(None, camera, sparse, alm.num_iters, alm.inlier_angle_deg,
                             alm.ransac_samples, dense=True, fit_idx=alm_draws[i % DRAW_BANK])
        return c, q.sum()

    stages["almeida"] = (alm_fn, None)
    stages["alm_sample"] = (
        lambda c, i: (c, draw_dense(gen, (batch,), n, alm.num_iters, 3, device).sum()
                      .to(torch.float32)), None)

    def fits_fn(c, i):
        idx = alm_draws[i % DRAW_BANK]
        pos = torch.stack([_take(sparse.pos[..., j], idx) for j in range(2)], dim=-1)
        mot = torch.stack([_take(sparse.motion[..., j], idx) for j in range(2)], dim=-1)
        return c, solve_ypr_weighted(camera, pos, mot, _take(sparse.mask, idx)).sum()

    stages["alm_fits"] = (fits_fn, None)
    stages["alm_refit"] = (
        lambda c, i: (c, solve_ypr_weighted(camera, sparse.pos, sparse.motion, sparse.mask)
                      .sum()), None)

    hom = create_estimator("homography")

    def hom_fn(c, i):
        q, _, _ = hom.estimate((), sparse, camera, dense=True, fit_idx=hom_draws[i % DRAW_BANK])
        return c, q.sum()

    stages["homography"] = (hom_fn, None)

    def hom_fit(lo: bool):
        def fn(c, i):
            res = robust_fit(
                sparse.pos, sparse.pos + sparse.motion, sparse.mask,
                minimal_fit=_minimal, sample_size=4, error_fn=homography_transfer_error,
                num_hypotheses=hypothesis_count(hp), threshold=hp.max_error,
                eval_cap=hp.eval_cap, adaptive_threshold=hp.adaptive_threshold,
                refit_fn=dlt_homography if lo else None, lo_iters=2 if lo else 0,
                prescore_cap=hp.prescore_cap, finalists=hp.finalists, dense=True,
                idx=hom_draws[i % DRAW_BANK],
            )
            return c, res.model.sum() + res.inliers.sum()

        return fn

    stages["hom_fit"] = (hom_fit(True), None)
    stages["hom_fit0"] = (hom_fit(False), None)

    det = create_detector("block_motion")

    def det_fn(c, i):
        d = det.detect(sparse)
        return c, d.field.sum() + d.area.sum()

    stages["detector"] = (det_fn, None)
    ddim = block_dim(det.params)
    stages["det_densify"] = (
        lambda c, i: (c, Densifier.zeros(ddim, ddim, (batch,), device).add_flow(sparse)
                      .finalize().sum()), None)
    act = (torch.rand((batch, ddim, ddim), generator=g) > 0.5).to(device)
    stages["det_label"] = (
        lambda c, i: (c, largest_component(act)[1].sum().to(torch.float32)), None)

    pipe = StreamPipeline(
        camera, [create_estimator("almeida"), create_estimator("homography")],
        create_detector("block_motion"), flow_params=params, emit_dense_flow=False,
        device=device,
    )

    step_gen = torch.Generator(device=device).manual_seed(4)

    def step_fn(st, i):
        st, out = pipe.step_from_frames(st, i2, step_gen)
        return st, step_checksum(out)

    stages["step"] = (step_fn, pipe.init_state(batch, h, w))
    return stages


def main(argv=None) -> int:
    from ofps_torch.apps.evaluate_matrix import device_line

    ap = argparse.ArgumentParser(prog="python -m ofps_torch.apps.profile_pipeline",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=96)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--stages", default=None, help="comma list to run (default: all)")
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    want = args.stages.split(",") if args.stages else list(STAGES)
    unknown = sorted(set(want) - set(STAGES))
    if unknown:
        ap.error(f"unknown stages {unknown}; have {list(STAGES)}")
    stages = build_stages(args.batch, args.height, args.width, device)
    results, device_us, detail = {}, {}, {}
    for name in STAGES:
        if name not in want:
            continue
        fn, carry0 = stages[name]
        r = timing.time_stage(fn, carry0, args.iters, max(1, args.repeats), device,
                              capture=name not in NOT_CAPTURED, graph_calls=GRAPH_CALLS)
        results[name] = r["best"] * 1e3
        device_us[name] = None if r["device_ms"] is None else r["device_ms"] * 1e3
        detail[name] = r
        dev = ("device time not measured" if r["device_ms"] is None
               else f"device {r['device_ms']:.4f} ms")
        print(f"{name:12s} {r['best']:9.4f} ms/call (median {r['median']:.4f}, host enqueue "
              f"{min(r['host_ms']):.4f}; {dev})", file=sys.stderr, flush=True)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    print(json.dumps({"unit": "us/step", "batch": args.batch, **results,
                      "device_us": device_us, "device": device_line(device),
                      "clock": timing.clock_name(device), "max_memory_allocated_bytes": peak,
                      "detail": detail}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
