#!/usr/bin/env python3
"""Profile the cv decoder's step (``ofps_torch.decoders.cv.CvFlowStep``) at
1080p on one CUDA GPU with ``torch.profiler``.

    python3 scripts/profile_cv_step.py [--iters 5]

For each flow algorithm (block matching, robust LK) and each path (hand
kernels, plain PyTorch), on the textured 3 px pan of ``chip_smoke.py``'s
cv phase (left third at 2% contrast):
the CUDA kernels launched per step, their summed device time, the span
from the first kernel's start to the last one's end, the device's busy and
idle share of that span, and the kernels that take the most device time.
Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5, help="profiled steps per case")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("CUDA is not available")
    import chip_smoke as cs
    from ofps_torch.decoders.cv import CvFlowStep

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    frames = cs.with_low_contrast_band(cs.moving_frames(torch, 2, 1, cs.H, cs.W, dev)[:, 0])
    prev_flow = torch.full((cs.H, cs.W, 2), cs.SHIFT, dtype=torch.float32, device=dev)
    for use_rlof in (False, True):
        for plain in (False, True):
            step = CvFlowStep(cs.H, cs.W, use_rlof=use_rlof, device=dev, plain=plain)
            for _ in range(2):
                step(frames[0], frames[1], prev_flow)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    step(frames[0], frames[1], prev_flow)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters
            kernels = [
                e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
            ]
            name = (f"cv_{'rlof' if use_rlof else 'sad'}_"
                    f"{'plain' if plain else 'kernel'} 1080p B=1")
            if not kernels:
                print(f"{name}: wall {wall_ms:.3f} ms/step; device time not measured "
                      f"(the profiler saw no CUDA events) | {smi}", flush=True)
                continue
            spans = [(e.time_range.start, e.time_range.end) for e in kernels]
            span = max(e for _, e in spans) - min(s for s, _ in spans)
            busy = busy_us(spans)
            by_name = defaultdict(float)
            for e in kernels:
                by_name[e.name] += e.time_range.elapsed_us()
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            print(f"{name}: wall {wall_ms:.3f} ms/step, {len(kernels) / args.iters:.0f} "
                  f"CUDA kernels/step, device time {busy / 1e3 / args.iters:.3f} "
                  f"ms/step, busy {busy / span:.3f} / idle {1 - busy / span:.3f} of the "
                  f"{span / 1e3 / args.iters:.3f} ms/step kernel span; top "
                  f"{[(n[:60], round(t / 1e3 / args.iters, 4)) for n, t in top]} "
                  f"(ms/step) | {smi}", flush=True)


if __name__ == "__main__":
    main()
