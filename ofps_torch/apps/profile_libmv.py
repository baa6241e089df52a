"""Sub-stage profile of the libmv estimator on the card (counterpart of the
JAX package's ``scripts/profile_libmv.py``, whose labels it keeps).

One libmv step broken into its stages, each a stage-truncated step timed
as ``--iters`` calls on the 150x84 synthetic-rotation field (12,600
vectors, the estimator table's input), so that the differences between
consecutive rows are per-stage costs:

  primary_solve  the primary robust fundamental solve -> (R, t), no GN polish
  primary_gn     the same with the Gauss-Newton pose polish
  find_nearest   the chain lookup of every vector in a full 40x40 index
  rasterize_x2   the two rasterize passes of one step
  chained_solve  the secondary solve on a 1600-point chained field
  whole_step     ``estimate_libmv`` from an empty carry

The RANSAC draws (the masked sampler's uniforms) come from a bank made
before the window, so that every stage can be captured.  Per stage: the
CUDA-event time per call (best and median of ``--repeats`` windows, with
the host's enqueue time) and its device-only time from a CUDA graph of 5
calls::

    python -m ofps_torch.apps.profile_libmv [--device cuda|cpu] [--iters 48]
        [--repeats 3]

Prints one line per stage, then one JSON line of ms per call.
"""

from __future__ import annotations

import argparse
import json

import torch

from ofps_torch.apps import timing
from ofps_torch.apps.bench_estimators import rotation_field
from ofps_torch.device import resolve_device
from ofps_torch.estimators.libmv import (
    GRID,
    LibmvParams,
    PrevMotion,
    _pose_from_field,
    estimate_libmv,
    find_nearest,
    hypothesis_count,
    rasterize_prev,
)

ITERS = 48
LABELS = ("primary_solve", "primary_gn", "find_nearest", "rasterize_x2", "chained_solve",
          "whole_step")
DRAW_BANK = 8
# Calls in a device-only graph: a call is up to ~10^4 kernels.
GRAPH_CALLS = 5


def chain_state(device) -> PrevMotion:
    """A full (1, 40, 40) index: every cell valid, start 0.3, motion 0.01."""
    return PrevMotion(
        pos=torch.full((1, GRID, GRID, 2), 0.3, device=device),
        motion=torch.full((1, GRID, GRID, 2), 0.01, device=device),
        valid=torch.ones((1, GRID, GRID), device=device),
        rot=torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=device),
        tr=torch.zeros((1, 3), device=device),
        has=torch.ones((1,), device=device),
    )


def build_stages(device, params: LibmvParams = LibmvParams()):
    """{label: fn(i) -> outputs (a tuple of tensors)} of the six stages on
    the 150x84 field on ``device``; call ``i`` takes the ``i``-th draws of
    the bank, in turn."""
    cam, flow, _ = rotation_field(device)
    pos, motion, w = flow
    h, k = hypothesis_count(params), params.algo_points
    gen = torch.Generator(device=device).manual_seed(0)
    bank = [(torch.rand((1, h, k), generator=gen, device=device),
             torch.rand((1, h, k), generator=gen, device=device)) for _ in range(DRAW_BANK)]
    st = chain_state(device)
    cp, cm, cw = st.pos.reshape(1, -1, 2), st.motion.reshape(1, -1, 2), st.valid.reshape(1, -1)
    no_gn = params._replace(gn_polish=False)
    empty = PrevMotion(*(x[None] for x in PrevMotion.empty(device)))

    def solve(p, x, m, v, i):
        return _pose_from_field(p, cam, x, m, v, bank[i % DRAW_BANK][0], None, False, False)

    return {
        "primary_solve": lambda i: solve(no_gn, pos, motion, w, i),
        "primary_gn": lambda i: solve(params, pos, motion, w, i),
        "find_nearest": lambda i: find_nearest(st, pos, w),
        "rasterize_x2": lambda i: (*rasterize_prev(pos, motion, w),
                                   *rasterize_prev(pos, motion + 0.001, w)),
        "chained_solve": lambda i: solve(params, cp, cm, cw, i),
        "whole_step": lambda i: estimate_libmv(params, empty, flow, cam, bank[i % DRAW_BANK]),
    }


def _checksum(outputs) -> torch.Tensor:
    """Sum of every tensor in a (nested) tuple of outputs, in float32."""
    if isinstance(outputs, torch.Tensor):
        return outputs.to(torch.float32).sum()
    return sum(_checksum(x) for x in outputs)


def main(argv=None) -> int:
    from ofps_torch.apps.evaluate_matrix import device_line

    ap = argparse.ArgumentParser(prog="python -m ofps_torch.apps.profile_libmv",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    stages = build_stages(device)
    results = {}
    for label in LABELS:
        fn = stages[label]
        r = timing.time_stage(lambda c, i, fn=fn: (c, _checksum(fn(i))), None, args.iters,
                              max(1, args.repeats), device, capture=True,
                              graph_calls=GRAPH_CALLS)
        results[label] = r
        dev = ("device time not measured" if r["device_ms"] is None
               else f"device {r['device_ms']:.3f} ms")
        print(f"{label:<22s}{r['best']:8.3f} ms/iter (median {r['median']:.3f}, host "
              f"enqueue {min(r['host_ms']):.3f}; {dev})", flush=True)
    print(json.dumps({"unit": "ms/iter", "device": device_line(device),
                      "clock": timing.clock_name(device), "iters": args.iters,
                      "stages": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
