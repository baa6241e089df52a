"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m ofps_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process, one run: make the inputs from the seed, build and warm the
served path (one capture of the consumers' graph), time ``--seconds``
seconds of steps on the harness's clock, then check what the window
produced against the reference.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics.  The last line of
standard output is one JSON object; the numbers compared, each with its
limit, are the last lines of standard error and the result's last key.
Fails without a CUDA card: there is no CPU fallback.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """``time.perf_counter()`` at the process's start (Linux's /proc)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T0 = _process_start()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ofps_tpu", "bench", "chip_smoke")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    the served path must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def p95(xs: List[float]) -> float:
    """The 95th percentile of all ``xs`` (linear between closest ranks)."""
    s = sorted(xs)
    k = 0.95 * (len(s) - 1)
    lo = int(k)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (k - lo)


class Record:
    """What a per-layer metric's reader reads."""

    def __init__(self, cell, served, t0: float):
        self.cell = cell
        self.served = served
        self.timeline = served.timeline
        self.setup_s = served.t_open - t0


def end_to_end(rec: Record) -> Dict[str, float]:
    s = rec.served
    return {
        "stream_fps": s.frames / s.window_s,
        "step_p95_ms": p95(s.step_s) * 1e3,
        "setup_s": rec.setup_s,
    }


def run_cell(cell, seed: int, seconds: float, tracing: bool, device,
             t0: float) -> Dict[str, Any]:
    """One run of ``cell`` on ``device``; returns the result's fields and
    the checks."""
    import torch

    from ofps_bench import check, serve, spec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.setdefault("USE_FLAX", "0")
    served = serve.SERVE[cell.config["input"]](cell, seed, seconds, tracing, device)
    dev = torch.device(device)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec = Record(cell, served, t0)
    e2e = end_to_end(rec)
    if tracing:
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"], cell.root)(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.numbers_of(cell, seed, served, dev)
    checks = check.judge(numbers, cell.config["limits"])
    counters = dict(served.counters)
    stamps = counters.pop("stamps")
    info = {"steps": len(served.step_s), "window_s": served.window_s,
            "step_ms_median": statistics.median(served.step_s) * 1e3, **counters,
            "setup_marks_s": {k: v - t0 for k, v in stamps.items()}}
    return {"served": served, "metrics": metrics, "checks": checks, "peak": peak,
            "info": info, "correct": check.passed(checks) and served.failed == 0}


def result_line(out: Dict[str, Any], device: Dict[str, Any],
                tracing: bool) -> Optional[Dict[str, Any]]:
    """The result's JSON object: the contract's keys, then the checks
    (None where a traced run traced no step)."""
    from ofps_bench import trace

    served = out["served"]
    result: Dict[str, Any] = {
        "correct": out["correct"],
        "attempted": served.frames,
        "failed": served.failed,
        "metrics": out["metrics"],
        "device": device,
    }
    if tracing:
        tl = served.timeline
        if tl is None or trace.steps(tl) <= 0:
            return None
        w0, w1 = trace.window(tl)
        device["busy_s"] = trace.busy_us(tl) / 1e6
        device["window_s"] = (w1 - w0) / 1e6
        result["breakdown"] = trace.breakdown(tl)
        out["info"]["graph_kernels_in_trace"] = tl.graph_kernels_seen
        out["info"]["traced_steps"] = trace.steps(tl)
        # The profiler's cost: a traced step's time against those of the
        # steps before the profiler started and after it stopped.
        before, after = served.untraced_step_s(), served.after_trace_step_s()
        out["info"].update(
            traced_step_ms_mean=(w1 - w0) / 1e3 / trace.steps(tl),
            untraced_step_ms_median=statistics.median(before) * 1e3 if before else None,
            after_trace_step_ms_median=statistics.median(after) * 1e3 if after else None,
            busy_ms_per_traced_step=trace.busy_us(tl) / 1e3 / trace.steps(tl))
    result["checks"] = out["checks"]
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from ofps_bench import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"ofps_bench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T0)
    bad = forbidden_modules()
    if bad:
        print(f"ofps_bench: the run loaded {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out["peak"]}
    result = result_line(out, device, bool(args.trace))
    if result is None:
        print("ofps_bench: the traced window is empty", file=sys.stderr)
        return 4
    print(json.dumps({"info": out["info"]}), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # Skip the interpreter's teardown: the profiler's CUDA tracing library
    # has crashed in it after a traced run.  Every thread the run started
    # has ended, and every file it wrote is closed.
    os._exit(rc)
