"""The served step on the harness's clock, where ``step_p95_ms`` is too
unsteady to be an end-to-end metric: the 95th percentile of the window
steps before the profiler started (the profiler slows the steps it traces
and those after them), ms."""

from ofps_bench.run import p95


def read(rec):
    xs = rec.served.untraced_step_s()
    return 1e3 * p95(xs) if xs else None
