"""Dense-flow attribution at 1080p on the card (counterpart of the JAX
package's ``scripts/perf_lab.py``; its ``PERF_B`` / ``PERF_ITERS``
environment knobs are the ``--batch`` / ``--iters`` flags here, with the
same defaults).  Modes, any of them in one run (default ``base``):

  base    ``dense_flow`` chained ``--iters`` times with the previous flow
          as the warm start, B=``--batch``
  cold    the same with no warm start
  parts   each pyramid level's refine alone at the frame's level shapes,
          through the kernel wrappers the pyramid calls there
          (``kernels.flow_refine`` at the axis-separable levels,
          ``kernels.flow_refine_small`` below them, and at the coarsest
          level the guarded pair: two ``flow_refine_small`` and one
          ``guard_select``), from a zero coarser flow
  ablate  ``FlowParams`` variants (``guarded_warm``, ``median_levels``,
          ``axis_sep``) through the benchmark's flow chain
          (``apps.bench.build_runner``) at B=1, ``--ablate-iters`` frames

Each measurement: one untimed warm-up, then ``--repeats`` CUDA-event
windows (best and median, with the host's enqueue time); ``parts`` adds
each level's device-only time from a CUDA graph of 20 calls.  Prints one
line per measurement, then one JSON line with the results and the peak of
``torch.cuda.max_memory_allocated``::

    python -m ofps_torch.apps.perf_lab [base] [cold] [parts] [ablate]
        [--device cuda|cpu] [--batch 16] [--iters 6] [--repeats 3]
        [--ablate-iters 192] [--height 1080] [--width 1920]
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from ofps_torch.apps import timing
from ofps_torch.apps.bench import build_runner, make_inputs
from ofps_torch.device import resolve_device
from ofps_torch.kernels import flow_refine as kfr
from ofps_torch.kernels import flow_refine_small as kfs
from ofps_torch.ops.flow_pyramid import (
    FlowParams,
    dense_flow,
    effective_levels,
    level_search,
    uses_axis_sep,
)
from ofps_torch.ops.image import build_pyramid

MODES = ("base", "cold", "parts", "ablate")
ABLATE = [
    ("default (guarded+median+axis_sep)", FlowParams()),
    ("guarded_warm=False", FlowParams(guarded_warm=False)),
    ("median_levels=False", FlowParams(median_levels=False)),
    ("both off", FlowParams(guarded_warm=False, median_levels=False)),
    ("axis_sep=False", FlowParams(axis_sep=False)),
]


def flow_chain(i1, i2, params: FlowParams, warm: bool):
    """fn(flow, i) -> (flow, checksum): one ``dense_flow`` from the carried
    flow as warm start (or from none)."""

    def fn(flow, i):
        f = dense_flow(i1, i2, params, init_flow=flow if warm else None)
        return f, f[..., 0].sum()

    return fn


def level_parts(i1, i2, params: FlowParams = FlowParams()):
    """[(label, fn(c, i) -> (c, checksum))]: each level's refine as the
    pyramid runs it, on the level images of ``i1``/``i2``, from a zero
    flow at the coarser level's size (at the coarsest level, at its own)."""
    h, w = i1.shape[-2:]
    levels = effective_levels(params, h, w)
    pyr1, pyr2 = build_pyramid(i1, levels), build_pyramid(i2, levels)
    win, cd = params.win, params.cost_dtype
    parts = []
    for lvl in range(levels):
        a, b = pyr1[lvl], pyr2[lvl]
        lh, lw = a.shape[-2:]
        search = level_search(params, lvl, levels)
        if lvl == levels - 1:
            z = torch.zeros_like(a)

            def fn(c, i, a=a, b=b, z=z, s=search):
                uw, vw = kfs.flow_refine_small(a, b, z, z, s, win, cd)
                u0, v0 = kfs.flow_refine_small(a, b, z, z, s, win, cd)
                u, v = kfs.guard_select(a, b, uw, vw, u0, v0, win)
                return c, u.sum() + v.sum()

            kind = "flow_refine_small x2 + guard_select"
        else:
            z = torch.zeros(a.shape[:-2] + (lh // 2, lw // 2), dtype=a.dtype, device=a.device)
            if uses_axis_sep(params, search, lh, lw):
                def fn(c, i, a=a, b=b, z=z):
                    u, v = kfr.flow_refine(a, b, z, z, win, cd)
                    return c, u.sum() + v.sum()

                kind = "flow_refine"
            else:
                def fn(c, i, a=a, b=b, z=z, s=search):
                    u, v = kfs.flow_refine_small(a, b, z, z, s, win, cd)
                    return c, u.sum() + v.sum()

                kind = "flow_refine_small"
        parts.append((f"level {lvl} ({lh}x{lw}) s={search} {kind}", fn))
    return parts


def _line(name: str, r: dict, frames: int) -> str:
    fps = frames / (r["best"] / 1e3)
    dev = "" if r.get("device_ms") is None else f", device {r['device_ms']:.4f} ms"
    return (f"{name:52s} {r['best']:9.4f} ms/call (median {r['median']:.4f}, host enqueue "
            f"{min(r['host_ms']):.4f}{dev})  {fps:9.1f} frames/s")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m ofps_torch.apps.perf_lab", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("modes", nargs="*", choices=MODES, help="default: base")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--ablate-iters", type=int, default=192)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    args = ap.parse_args(argv)
    args.modes = args.modes or ["base"]
    return args


def main(argv=None) -> int:
    from ofps_torch.apps.evaluate_matrix import device_line

    args = parse_args(argv)
    device = resolve_device(args.device)
    b, h, w, reps = args.batch, args.height, args.width, max(1, args.repeats)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    i1, i2 = make_inputs(b, h, w, device)
    out = {"device": device_line(device), "clock": timing.clock_name(device), "batch": b,
           "height": h, "width": w}
    zero = torch.zeros((b, h, w, 2), dtype=torch.float32, device=device)
    for mode, warm in (("base", True), ("cold", False)):
        if mode in args.modes:
            r = timing.time_stage(flow_chain(i1, i2, FlowParams(), warm), zero, args.iters, reps,
                                  device, capture=False)
            out[mode] = r
            print(_line(f"{mode}: dense_flow B={b} {'warm' if warm else 'no warm start'}", r, b),
                  flush=True)
    if "parts" in args.modes:
        out["parts"] = {}
        for name, fn in level_parts(i1, i2):
            r = timing.time_stage(fn, None, args.iters, reps, device, capture=True)
            out["parts"][name] = r
            print(_line(f"parts: {name}", r, b), flush=True)
        total = sum(r["best"] for r in out["parts"].values())
        print(f"parts: sum of levels {total:.4f} ms/call (B={b})", flush=True)
    if "ablate" in args.modes:
        out["ablate"] = {}
        a1, a2 = i1[:1].contiguous(), i2[:1].contiguous()
        for name, params in ABLATE:
            run = build_runner(1, h, w, args.ablate_iters, params)
            run(a1, a2).item()
            ms = [timing.timed(lambda: run(a1, a2), device)[0] for _ in range(reps)]
            fps = args.ablate_iters / (min(ms) / 1e3)
            out["ablate"][name] = {"ms": ms, "fps_best": fps,
                                   "fps_median": args.ablate_iters / (statistics.median(ms) / 1e3)}
            print(f"ablate: {name:40s} {fps:9.1f} frames/s (B=1, {args.ablate_iters} frames)",
                  flush=True)
    if device.type == "cuda":
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(device)
        print(f"peak torch.cuda.max_memory_allocated {out['max_memory_allocated_bytes'] / 2**30:.2f} "
              "GiB", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
