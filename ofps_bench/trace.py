"""The traced run's device timeline, from ``torch.profiler`` (CPU and CUDA
activities) over a few steady steps of the window.

The harness marks its own boundaries with ``record_function`` ranges named
``ofps_bench.*``: ``ofps_bench.step`` from each traced step's start to the
next's, ``ofps_bench.upload`` around a frames step's frame upload and
conversion, ``ofps_bench.fetch`` around its result copies.  Device
operations are classed by the runtime call that launched them (the
``correlation`` of the Kineto trace): a kernel launched by
``cudaGraphLaunch`` ran inside the consumers' CUDA graph; one launched from
inside a harness range is the harness's.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, NamedTuple, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HAND_KERNELS = ("refine_sep_kernel", "refine_2d_kernel", "guard_kernel")


class Op(NamedTuple):
    name: str
    start: float  # us, the trace's clock
    dur: float  # us
    kind: str  # "graph", "harness" or "eager"


class Timeline(NamedTuple):
    """Device operations and host ranges of the traced steps."""

    ops: List[Op]  # device operations, by start
    marks: List[float]  # step starts (us), one past the last traced step
    host: List[Tuple[str, float, float]]  # (name, start, dur) host ranges of the main thread
    graph_kernels_seen: bool  # the trace shows the kernels inside graph replays


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


class StepRanges:
    """``ofps_bench.step`` ranges: :meth:`next` ends the open one and opens
    another, :meth:`close` ends the last."""

    def __init__(self):
        self._open = None

    def next(self) -> None:
        from torch.autograd.profiler import record_function

        self.close()
        self._open = record_function("ofps_bench.step")
        self._open.__enter__()

    def close(self) -> None:
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None


def read_trace(prof) -> Timeline:
    """Parse the profiler's Kineto trace (written to a temporary file under
    ``TMPDIR`` and deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="ofps_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return parse_events(events)


def parse_events(events) -> Timeline:
    ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("name") == "ofps_bench.step")
    marks = [a for a, _ in ranges] + [ranges[-1][1]] if ranges else []
    if not ranges:
        import collections
        import sys

        cats = collections.Counter(e.get("cat") for e in events)
        names = sorted({e.get("name") for e in events if "ofps_bench" in str(e.get("name"))})
        print(f"trace: {len(events)} events, {dict(cats)}, harness ranges {names}",
              file=sys.stderr)
    harness = [(e["ts"], e["ts"] + e["dur"], e.get("tid")) for e in events
               if e.get("ph") == "X" and e.get("cat") == "user_annotation"
               and e.get("name") in ("ofps_bench.upload", "ofps_bench.fetch")]
    graph_corr, harness_corr = set(), set()
    main_tid = None
    host = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat == "cuda_runtime" or cat == "cuda_driver":
            corr = (e.get("args") or {}).get("correlation")
            if e.get("name", "").startswith("cudaGraphLaunch"):
                graph_corr.add(corr)
            ts = e["ts"]
            if any(a <= ts <= b and (tid is None or tid == e.get("tid")) for a, b, tid in harness):
                harness_corr.add(corr)
        if cat in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function"):
            host.append((e["name"], e["ts"], e.get("dur", 0.0), e.get("tid")))
            if e.get("name") == "ofps_bench.step":
                main_tid = e.get("tid")
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        corr = (e.get("args") or {}).get("correlation")
        kind = "graph" if corr in graph_corr else "harness" if corr in harness_corr else "eager"
        ops.append(Op(e["name"], float(e["ts"]), float(e["dur"]), kind))
    ops.sort(key=lambda o: o.start)
    host = [(n, s, d) for n, s, d, tid in host if main_tid is None or tid == main_tid]
    host.sort(key=lambda h: h[1])
    return Timeline(ops, marks, host, any(o.kind == "graph" for o in ops))


def window(tl: Timeline) -> Tuple[float, float]:
    return tl.marks[0], tl.marks[-1]


def steps(tl: Timeline) -> int:
    return len(tl.marks) - 1


def in_window(tl: Timeline) -> List[Op]:
    w0, w1 = window(tl)
    return [o for o in tl.ops if o.start >= w0 and o.start < w1]


def busy_us(tl: Timeline) -> float:
    """Microseconds of the window in which some device operation ran."""
    w0, w1 = window(tl)
    total, end = 0.0, w0
    for o in tl.ops:
        a, b = max(o.start, end), min(o.start + o.dur, w1)
        if b > a:
            total += b - a
            end = b
    return total


def gaps(tl: Timeline) -> List[Tuple[float, float]]:
    """Idle intervals of the device inside the window, longest first."""
    w0, w1 = window(tl)
    out, end = [], w0
    for o in tl.ops:
        if o.start + o.dur <= w0 or o.start >= w1:
            continue
        if o.start > end:
            out.append((end, o.start))
        end = max(end, o.start + o.dur)
    if w1 > end:
        out.append((end, w1))
    return sorted(out, key=lambda g: g[0] - g[1])


def host_at(tl: Timeline, t: float) -> str:
    """The innermost host range of the main thread open at ``t``."""
    best = None
    for name, s, d in tl.host:
        if s > t:
            break
        if s + d >= t and (best is None or s >= best[1]):
            best = (name, s)
    return best[0] if best else "(no host range)"


def breakdown(tl: Timeline, n: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle
    gaps by the host range open at their middle (seconds)."""
    by_name: Dict[str, float] = {}
    for o in in_window(tl):
        by_name[o.name] = by_name.get(o.name, 0.0) + o.dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    idle = [[host_at(tl, (a + b) / 2), (b - a) / 1e6] for a, b in gaps(tl)[:n]]
    return {"device_ops": [[k, v / 1e6] for k, v in top], "idle_gaps": idle}


def step_ops(tl: Timeline) -> List[List[Op]]:
    """The device operations of each traced step: those that start between
    the step's first harness or eager operation and the next step's."""
    per = [[] for _ in range(steps(tl))]
    ms = tl.marks
    i = 0
    for o in in_window(tl):
        while i + 1 < len(ms) - 1 and o.start >= ms[i + 1]:
            i += 1
        per[i].append(o)
    return per


def flow_ops(ops: List[Op]) -> List[Op]:
    """A frames step's dense flow: the eager operations after its frame
    upload, up to and with the last hand kernel (the pyramid, the warm
    start's resize and the refine, guard and grid launches)."""
    eager = [o for o in ops if o.kind == "eager"]
    last = max((i for i, o in enumerate(eager) if any(k in o.name for k in HAND_KERNELS)),
               default=-1)
    return eager[: last + 1]


def hand_kernel_us(ops: List[Op]) -> Dict[str, float]:
    out = {k: 0.0 for k in HAND_KERNELS}
    for o in ops:
        for k in HAND_KERNELS:
            if k in o.name:
                out[k] += o.dur
    return out


def mean_per_step(tl: Optional[Timeline], fn) -> Optional[float]:
    """Mean over the traced steps of ``fn(step's ops)`` (us), in ms."""
    if tl is None or steps(tl) <= 0:
        return None
    return sum(fn(ops) for ops in step_ops(tl)) / steps(tl) / 1e3
