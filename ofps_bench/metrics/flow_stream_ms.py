"""Dense flow (``ops/flow_pyramid``, ``kernels/``): device ms of a frames
step's flow, from the program's CUDA events around ``dense_flow_warm``
through the grid's finish (span ``flow``), median over the window steps
before the profiler started.  On the card's clock with no profiler, it
counts the idle between the flow's launches that the profiler's kernel sum
(``flow_device_ms``) leaves out.  Nothing where the program records no such
span."""

from ofps_bench import serve


def read(rec):
    from ofps_torch.pipeline import runtime

    perf = runtime.last_perf() if hasattr(runtime, "last_perf") else None
    if perf is None:
        return None
    steps = serve.before_trace(rec.served.window, rec.served.traced)
    return perf.median_ms("flow", steps, device=True)
