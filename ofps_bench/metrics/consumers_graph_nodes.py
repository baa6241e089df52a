"""Consumers (``parallel/stream._CapturedCall``): the node count of the
consumers' CUDA graph the run captured last (span ``consumers.capture``,
CUDA's ``cuGraphGetNodes`` on the kept graph).  Nothing where the
program records no count."""


def read(rec):
    from ofps_torch.pipeline import runtime

    perf = runtime.last_perf() if hasattr(runtime, "last_perf") else None
    if perf is None:
        return None
    nodes = [sp.nodes for spans in perf.spans.values() for sp in spans
             if sp.name == "consumers.capture" and sp.nodes is not None]
    return float(nodes[-1]) if nodes else None
