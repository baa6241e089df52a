"""Consumers (``parallel/stream._run_consumers``): device ms of multiview's
section of the consumers' CUDA-graph replay (span
``consumers.est.multiview``, between the two timing events that the graph
records around the estimator's nodes), median over the window steps
before the profiler started.  Nothing where the program records no such
span, or records it with host times only."""

from ofps_bench import serve


def read(rec):
    from ofps_torch.pipeline import runtime

    perf = runtime.last_perf() if hasattr(runtime, "last_perf") else None
    if perf is None:
        return None
    steps = serve.before_trace(rec.served.window, rec.served.traced)
    return perf.median_ms("consumers.est.multiview", steps, device=True)
