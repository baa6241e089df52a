"""Consumers (``parallel/stream._run_consumers``: estimators and detector,
one CUDA graph): device ms a traced step of the kernels the graph replay
ran.  Nothing where the trace shows no kernel inside a graph replay."""

from ofps_bench import trace


def read(rec):
    tl = rec.timeline
    if tl is None or not tl.graph_kernels_seen:
        return None
    return trace.mean_per_step(tl, lambda ops: sum(o.dur for o in ops if o.kind == "graph"))
