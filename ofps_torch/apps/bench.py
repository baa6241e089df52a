"""Headline benchmark of the port (counterpart of the repository root's
``bench.py``): dense 1080p optical flow in frames/s on one card, and the
complete serving step's frames/s.

    python -m ofps_torch.apps.cli [--device cuda|cpu] bench [--batch 1]
        [--iters 192] [--repeats 3] [--height 1080] [--width 1920]
        [--no-pipeline] [--profile DIR]

Prints one human line per measurement on stderr and, as its last line on
stdout, one JSON object with ``bench.py``'s keys: ``metric``, ``value``
(dense-flow frames/s), ``unit``, ``vs_baseline`` (over the reference's
OpenCV Farneback on a CPU, 45.679 ms/frame), ``pipeline_1080p_fps_per_chip``
(``{"b1", "b4", "b8"}``: the serving step, almeida + homography +
block_motion) and ``pipeline_all4_fps_per_chip`` (all four estimators at
B=8), plus ``detail``: every repeat's ms, host enqueue ms and checksum,
the best and median, the card and the clock.

* The flow: :func:`build_runner`, a ``dense_flow_stream`` chain of
  ``iters`` frames with the streaming carry (each frame's pyramid built
  once), every frame's full-resolution flow summed into a checksum.
* The serving step: :func:`build_pipeline_runner`, ``StreamPipeline.
  step_from_frames`` chained on one constant frame at B = 1, 4, 8 (96 steps)
  and all four at B=8 (24 steps), every output in the checksum
  (:func:`step_checksum`).

Timing: the first run (on the card: the kernels' build and the consumers'
CUDA graph capture) is a warm-up outside the timed window.  A window is two
CUDA events around the chained steps and ends on ``.item()`` of the
checksum (:mod:`ofps_torch.apps.timing`); frames/s is ``B * iters / best``.
A graph's replay time depends on its capture, so each pipeline repeat
builds a fresh pipeline and captures anew.  ``--repeats`` sets the repeats
of every measurement.  ``--profile DIR`` writes a ``torch.profiler`` trace
of one timed flow run to ``DIR/bench_trace.json`` (and skips the
pipeline, as ``bench.py`` does).

There is no fallback: without a card the default device raises, and a run
on ``--device cpu`` times the CPU (``detail["clock"]`` is "host clock").
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from typing import Optional, Sequence

import torch

from ofps_torch.apps import timing
from ofps_torch.core.camera import StandardCamera
from ofps_torch.detectors.base import create_detector
from ofps_torch.device import resolve_device
from ofps_torch.estimators.base import create_estimator
from ofps_torch.ops.flow_pyramid import FlowParams, dense_flow_stream
from ofps_torch.parallel.stream import StreamPipeline

BASELINE_FPS = 1000.0 / 45.679  # the reference's OpenCV dense flow on a CPU
SERVING = ("almeida", "homography")
ALL4 = ("almeida", "homography", "multiview", "libmv")
PIPELINE_BATCHES = (1, 4, 8)
PIPELINE_ITERS = 96
ALL4_BATCH = 8
ALL4_ITERS = 24


def step_checksum(out) -> torch.Tensor:
    """Scalar consuming EVERY pipeline output.

    Honesty-critical: XLA's while-loop simplifier strips dead carry/output
    elements, so in the JAX package any stage whose outputs the benchmark
    does not consume is dead-code-eliminated from the loop entirely.  Round
    4 caught exactly this: a rot[0]-only checksum silently reduced the "full
    pipeline" numbers to flow+densify+almeida.  PyTorch eliminates nothing,
    but the rule stands: every estimator's pose (rot and pos) and the
    detector's verdicts feed the returned scalar, so a stage that drops or
    breaks an output moves the number.
    """
    s = sum(r.sum() for r in out.rot) + sum(p.sum() for p in out.pos)
    if out.detection is not None:
        s = s + out.detection.detected.to(torch.float32).sum()
    return s


def make_inputs(batch: int, h: int, w: int, device, seed: int = 0):
    """(i1, i2): ``i1`` uniform in [0, 255), ``i2`` = ``i1`` rolled 3 px
    right plus U(-2, 2) noise; drawn on the CPU from a seeded
    ``torch.Generator`` (the same inputs on every device), then moved."""
    g = torch.Generator().manual_seed(seed)
    i1 = torch.rand((batch, h, w), generator=g) * 255.0
    i2 = torch.roll(i1, 3, dims=-1) + (torch.rand((batch, h, w), generator=g) * 4.0 - 2.0)
    return i1.to(device), i2.to(device)


def build_runner(batch: int, h: int, w: int, iters: int, params: FlowParams = FlowParams()):
    """``run(i1, i2)``: the carry from ``i1``, then ``iters`` frames of
    ``i2`` through ``dense_flow_stream`` (each frame's pyramid built once,
    the half-resolution warm start carried); returns the 0-d sum over the
    frames of ``sum(u) + sum(v)`` of the full-resolution flow."""

    def run(i1: torch.Tensor, i2: torch.Tensor) -> torch.Tensor:
        if i1.shape != (batch, h, w):
            raise ValueError(f"frames {tuple(i1.shape)}, runner built for {(batch, h, w)}")
        _, carry = dense_flow_stream(i1, params)
        acc = None
        for _ in range(iters):
            (u, v), carry = dense_flow_stream(i2, params, carry)
            s = u.sum() + v.sum()
            acc = s if acc is None else acc + s
        return acc

    return run


def build_pipeline_runner(batch: int, h: int, w: int, iters: int,
                          estimators: Sequence[str] = SERVING, device="cuda"):
    """``run(gray, generator, steps=iters, draws=None)``: ``steps``
    chained ``step_from_frames`` calls of the serving pipeline
    (``estimators`` + block_motion, ``FlowParams()``, no full-resolution
    flow stored) on the (batch, h, w) frame ``gray``; the state (the
    previous frame's pyramid, the warm start, the poses, the estimators'
    carries) is kept between calls, from a fresh ``init_state``.  Returns
    the 0-d sum of :func:`step_checksum` over the steps.  ``draws``:
    optional per-step ``step_from_frames`` draws in place of the
    generator's (parity tests inject JAX's).  ``run.pipe`` is the
    pipeline."""
    pipe = StreamPipeline(
        camera=StandardCamera.create(w / h, 90.0),
        estimators=[create_estimator(name) for name in estimators],
        detector=create_detector("block_motion"),
        flow_params=FlowParams(),
        emit_dense_flow=False,
        device=device,
    )
    state = pipe.init_state(batch, h, w)

    def run(gray: torch.Tensor, generator: Optional[torch.Generator], steps: int = iters,
            draws=None) -> torch.Tensor:
        nonlocal state
        acc = None
        for t in range(steps):
            state, out = pipe.step_from_frames(
                state, gray, generator, draws=None if draws is None else draws[t])
            s = step_checksum(out)
            acc = s if acc is None else acc + s
        return acc

    run.pipe = pipe
    return run


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _summary(b: int, iters: int, windows) -> dict:
    """Per-measurement detail of (ms, host ms, checksum) windows."""
    ms = [m for m, _, _ in windows]
    return {
        "batch": b, "iters": iters, "ms": ms, "host_ms": [h for _, h, _ in windows],
        "checksum": [c for _, _, c in windows],
        "best_ms": min(ms), "median_ms": statistics.median(ms),
        "fps_best": b * iters / (min(ms) / 1e3),
        "fps_median": b * iters / (statistics.median(ms) / 1e3),
    }


def bench_pipeline(h: int, w: int, device, batches=PIPELINE_BATCHES, iters: int = PIPELINE_ITERS,
                   estimators: Sequence[str] = SERVING, repeats: int = 3) -> dict:
    """{"b<B>": detail} of the serving step per batch size: each repeat a
    fresh pipeline, its first step (the graph capture) untimed, then one
    window of ``iters`` chained steps."""
    out = {}
    for b in batches:
        gray = make_inputs(b, h, w, device, seed=1)[0]
        windows = []
        for _ in range(repeats):
            run = build_pipeline_runner(b, h, w, iters, estimators, device)
            gen = torch.Generator(device=device).manual_seed(1)
            run(gray, gen, 1).item()
            windows.append(timing.timed(lambda: run(gray, gen), device))
            del run
            if device.type == "cuda":
                torch.cuda.empty_cache()
        d = out[f"b{b}"] = _summary(b, iters, windows)
        _log(f"pipeline {'+'.join(estimators)} + block_motion B={b} {h}x{w}: "
             f"{d['fps_best']:.2f} fps best, {d['fps_median']:.2f} median; ms per window "
             f"{[round(m, 3) for m in d['ms']]} (host enqueue "
             f"{[round(x, 3) for x in d['host_ms']]}), {iters} steps")
    return out


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(prog="ofps-torch bench", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=192)
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed repeats of every measurement; best and median reported")
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--no-pipeline", action="store_true",
                    help="skip the serving-step sweep (flow only)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of one timed flow run into DIR")
    args = ap.parse_args(argv)
    device = resolve_device(device)
    b, h, w, repeats = args.batch, args.height, args.width, max(1, args.repeats)

    i1, i2 = make_inputs(b, h, w, device)
    run = build_runner(b, h, w, args.iters)
    _log(f"flow on {device} (batch={b}, {h}x{w}, iters={args.iters}): warm-up run...")
    run(i1, i2).item()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            windows = [timing.timed(lambda: run(i1, i2), device)]
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "bench_trace.json"))
    else:
        windows = [timing.timed(lambda: run(i1, i2), device) for _ in range(repeats)]
    flow = _summary(b, args.iters, windows)
    _log(f"flow B={b} {h}x{w}: {flow['fps_best']:.2f} fps best, {flow['fps_median']:.2f} "
         f"median; ms per window {[round(m, 3) for m in flow['ms']]} (host enqueue "
         f"{[round(x, 3) for x in flow['host_ms']]}), {args.iters} frames")

    from ofps_torch.apps.evaluate_matrix import device_line

    fps = flow["fps_best"]
    record = {
        "metric": "dense_flow_1080p_fps_per_chip",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 2),
    }
    detail = {"device": device_line(device), "clock": timing.clock_name(device),
              "height": h, "width": w, "flow": flow}
    if not args.no_pipeline and not args.profile:
        _log("benchmarking the serving step...")
        pipe = bench_pipeline(h, w, device, iters=PIPELINE_ITERS, repeats=repeats)
        record["pipeline_1080p_fps_per_chip"] = {k: round(d["fps_best"], 2) for k, d in pipe.items()}
        _log("benchmarking the all-estimator step...")
        all4 = bench_pipeline(h, w, device, batches=(ALL4_BATCH,), iters=ALL4_ITERS,
                              estimators=ALL4, repeats=repeats)[f"b{ALL4_BATCH}"]
        record["pipeline_all4_fps_per_chip"] = round(all4["fps_best"], 2)
        detail.update(pipeline=pipe, all4=all4)
    if device.type == "cuda":
        detail["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(device)
    record["detail"] = detail
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
