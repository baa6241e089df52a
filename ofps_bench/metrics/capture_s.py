"""Consumers (``parallel/stream._run_consumers``): host seconds of the
run's captures of the consumers' CUDA graph (span ``consumers.capture``:
the warm-up call, the capture and the graph's instantiation), all part of
the set-up.  Nothing where the program records no capture."""


def read(rec):
    from ofps_torch.pipeline import runtime

    perf = runtime.last_perf() if hasattr(runtime, "last_perf") else None
    if perf is None:
        return None
    ms = perf.per_step("consumers.capture")
    return sum(ms.values()) / 1e3 if ms else None
