"""Step entry on the codec path (``StreamPipeline.step_from_flow``, host):
the program's ``PerfStats`` "step", the host's time to enqueue the draws,
the graph's input copies and replay and the fetch's copies, mean ms a
window step before the profiler started."""


def read(rec):
    xs = rec.served.perf.get("step")
    return 1e3 * sum(xs) / len(xs) if xs else None
