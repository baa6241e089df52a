"""Step entry on the frames path (``LivePipeline.step`` ->
``StreamPipeline.step_from_frames``, host): the harness's clock around
the call, mean ms a window step before the profiler started."""


def read(rec):
    xs = rec.served.perf.get("enqueue")
    return 1e3 * sum(xs) / len(xs) if xs else None
