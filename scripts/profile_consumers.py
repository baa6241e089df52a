#!/usr/bin/env python3
"""Profile the serving step's consumers (estimators + detector) on one CUDA
GPU with ``torch.profiler``.

    python3 scripts/profile_consumers.py [--batch 4] [--top 12] [--sets serving|all4]

For ``--sets serving``: almeida alone, homography alone and both; for
``--sets all4``: multiview alone, libmv alone and all four (each with
block_motion), on the grid that ``chip_smoke.py``'s 3 px scene gives the
1080p serving step:
the consumers' CUDA-graph replay time (CUDA events), and for the same
calls made eagerly the CUDA kernels, their summed device time, the
kernels that take the most of it and the PyTorch operations whose
kernels take the most (self device time).  Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4, help="streams")
    ap.add_argument("--top", type=int, default=12, help="kernels listed by device time")
    ap.add_argument("--sets", choices=("serving", "all4"), default="serving",
                    help="estimator sets: the serving step's, or the all-estimator one's")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("CUDA is not available")
    import chip_smoke as cs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    b = args.batch
    frames = cs.moving_frames(torch, 2, b, cs.H, cs.W, dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    grid = None
    sets = ((("almeida",), ("homography",), cs.ESTIMATORS) if args.sets == "serving"
            else (("multiview",), ("libmv",), cs.ALL4))
    for names in sets:
        pipe = cs.make_pipeline(dev, False, names)
        st = pipe.init_state(b, cs.H, cs.W)
        if grid is None:
            st1, _ = pipe.step_from_frames(st, frames[0], gen)
            grid = pipe.step_from_frames(st1, frames[1], gen)[1].grid
        n = grid.shape[1] * grid.shape[2]
        draws = tuple(e.draw(gen, (b,), n, dev) for e in pipe.estimators)
        replay_ms = cs.time_ms(torch, lambda: pipe._run_consumers(st, grid, draws, None), 10)[0]
        pipe._consume(grid, st.rot, st.pos, draws, st.est)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pipe._consume(grid, st.rot, st.pos, draws, st.est)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        name = "+".join(names) + f" + block_motion B={b}"
        if not kernels:
            print(f"{name}: graph replay {replay_ms:.3f} ms; kernels not measured (the "
                  f"profiler saw no CUDA events) | {smi}", flush=True)
            continue
        by_name, count = defaultdict(float), defaultdict(int)
        for e in kernels:
            by_name[e.name] += e.time_range.elapsed_us()
            count[e.name] += 1
        total = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[: args.top]
        print(f"{name}: graph replay {replay_ms:.3f} ms; eagerly {len(kernels)} CUDA kernels, "
              f"{total / 1e3:.3f} ms of kernel time | {smi}", flush=True)
        for k, us in top:
            print(f"    {us / 1e3:8.3f} ms  {count[k]:6d}x  {k[:110]}", flush=True)
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
        print("  by operation:", flush=True)
        for e in ops[: args.top]:
            print(f"    {e.self_device_time_total / 1e3:8.3f} ms  {e.count:6d}x  {e.key}", flush=True)


if __name__ == "__main__":
    main()
