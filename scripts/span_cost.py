#!/usr/bin/env python3
"""Host cost of the always-on spans of one served step, timed on its own.

    python3 scripts/span_cost.py [--steps 20000] [--device cuda|cpu]

Replays, with no work inside them, the recorder calls
(``ofps_torch.pipeline.runtime.PerfStats``) that one step makes on each
served path, in the order the program makes them: the codec path
(``apps/batch.run_batch``: ``step``, ``decode.work``, ``upload.wait``,
``upload.pack``, then ``pipeline.step``, ``draws``, ``consumers`` and the
graph's ``copy_in``, ``launch`` with its CUDA events, ``clone``) and the
frames path (``step``, ``flow`` with its CUDA events, ``draws``,
``consumers``, the graph's three).  Prints one JSON line: host microseconds
a step on each path, the median of 5 repeats, with the profiler off (as in
an untraced run).  On ``cuda`` the events are recorded on the card and read
back lazily, as in a run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _graph_call(perf, dev):
    sp = perf.open("consumers.copy_in")
    sp = perf.open("consumers.launch", t=perf.close(sp), device=dev)
    sp = perf.open("consumers.clone", t=perf.close(sp))
    perf.close(sp)


def codec_step(perf, k, dev):
    with perf.span("step", step=k):
        perf.record("decode.work", 0.0, 0.0)
        with perf.span("upload.wait"):
            pass
        with perf.span("upload.pack"):
            pass
        with perf.span("pipeline.step"):
            sp = perf.open("draws")
            with perf.span("consumers", t=perf.close(sp)):
                _graph_call(perf, dev)


def frames_step(perf, k, dev):
    with perf.span("step"):
        sp = perf.open("flow", device=dev)
        sp = perf.open("draws", t=perf.close(sp))
        with perf.span("consumers", t=perf.close(sp)):
            _graph_call(perf, dev)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from ofps_torch.pipeline.runtime import PerfStats

    dev = torch.device(args.device)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "steps": args.steps}
    for name, step in (("codec_us", codec_step), ("frames_us", frames_step)):
        reps = []
        for _ in range(5):
            perf = PerfStats()
            for k in range(200):  # the event pool fills, as in a run's first steps
                step(perf, k, dev)
            t0 = time.perf_counter()
            for k in range(200, 200 + args.steps):
                step(perf, k, dev)
            reps.append((time.perf_counter() - t0) / args.steps * 1e6)
        out[name] = statistics.median(reps)
        out[name + "_reps"] = reps
    print(json.dumps(out))


if __name__ == "__main__":
    main()
