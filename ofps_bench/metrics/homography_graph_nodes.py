"""Consumers (``pipeline/graphs.CapturedCall``): the nodes of homography's
section in the consumers' CUDA graph the run captured last (span
``consumers.capture``, its ``nodes_by_section``: CUDA's
``cuGraphGetNodes`` on the graph in progress before and after the
section).  Nothing where the program records no such count."""


def read(rec):
    from ofps_torch.pipeline import runtime

    perf = runtime.last_perf() if hasattr(runtime, "last_perf") else None
    if perf is None:
        return None
    nodes = [(getattr(sp, "nodes_by_section", None) or {}).get("homography")
             for spans in perf.spans.values() for sp in spans if sp.name == "consumers.capture"]
    nodes = [n for n in nodes if n is not None]
    return float(nodes[-1]) if nodes else None
