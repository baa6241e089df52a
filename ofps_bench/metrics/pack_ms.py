"""Pack and upload (``apps/batch.FlowUploader.pack``): host ms of the
zero-fill of the pinned buffer and the B ``pack_entries`` (span
``upload.pack``; the wait on the buffer's last copy before it is
``upload.wait``), median over the window steps before the profiler
started.  Nothing where the program records no such span."""

from ofps_bench import serve


def read(rec):
    from ofps_torch.pipeline import runtime

    perf = runtime.last_perf() if hasattr(runtime, "last_perf") else None
    if perf is None:
        return None
    steps = serve.before_trace(rec.served.window, rec.served.traced)
    return perf.median_ms("upload.pack", steps)
