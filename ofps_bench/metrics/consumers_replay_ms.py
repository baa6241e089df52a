"""Consumers (``parallel/stream._CapturedCall``): device ms of the
consumers' CUDA-graph replay, from the program's CUDA events around
``graph.replay()`` (span ``consumers.launch``), median over the window steps
before the profiler started.  The events time the replay on the card's own
clock, with no profiler: the idle between the graph's nodes counts, the
host's work before the launch does not.  Nothing where the program records
no such span."""

from ofps_bench import serve


def read(rec):
    from ofps_torch.pipeline import runtime

    perf = runtime.last_perf() if hasattr(runtime, "last_perf") else None
    if perf is None:
        return None
    steps = serve.before_trace(rec.served.window, rec.served.traced)
    return perf.median_ms("consumers.launch", steps, device=True)
