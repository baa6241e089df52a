#!/usr/bin/env python3
"""Time and profile the host side of the sharded serving step on CUDA.

    python3 scripts/profile_sharded_step.py [--batch 8] [--top 18]

``chip_smoke.py``'s serving configuration (almeida + homography +
block_motion) at 1080p on a (stream, space) = (2, 2) mesh: with every
position on cuda:0, and with one card per position where there are four.
For each: the step's CUDA-event ms and the host's ms to enqueue it
(``chip_smoke.time_ms``, 10 steps), the same for one row's band flow
alone, then ``torch.profiler``'s host operations of one step by self CPU
time (a ``cudaStreamSynchronize`` there is the host waiting for a card).
Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8, help="streams")
    ap.add_argument("--top", type=int, default=18, help="host operations listed")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from ofps_torch.kernels import build
    from ofps_torch.parallel import make_stream_mesh, stream_sharding
    from ofps_torch.parallel.spatial import dense_flow_warm_spatial

    build.library()
    dev = torch.device("cuda", 0)
    b = args.batch
    frames = cs.moving_frames(torch, 2, b, cs.H, cs.W, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    n = torch.cuda.device_count()
    meshes = {"one card": make_stream_mesh(4, space=2, devices=["cuda:0"] * 4)}
    if n >= 4:
        meshes["four cards"] = make_stream_mesh(4, space=2, devices=[f"cuda:{i}" for i in range(4)])
    for name, mesh in meshes.items():
        pipe = cs.make_pipeline(dev, False, shardings=stream_sharding(mesh))
        st, _ = pipe.step_from_frames(pipe.init_state(b, cs.H, cs.W), frames[0], gen)
        ms, host = cs.time_ms(torch, lambda: pipe.step_from_frames(st, frames[1], gen), 10)
        row, s0 = pipe._rows[0], st[0]
        g0 = frames[1][: b // 2].contiguous()
        fms, fhost = cs.time_ms(torch, lambda: dense_flow_warm_spatial(
            s0.prev_cache.pyr[0], g0, row.flow_params, s0.warm_uv, row._band_mesh), 10)
        print(f"{name}: step {ms:.3f} ms host {host:.3f}; one row's band flow {fms:.3f} ms "
              f"host {fhost:.3f}", flush=True)
        cs.sync_all(torch)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pipe.step_from_frames(st, frames[1], gen)
        cs.sync_all(torch)
        print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=args.top),
              flush=True)


if __name__ == "__main__":
    main()
