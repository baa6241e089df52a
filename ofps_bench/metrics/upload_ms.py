"""Pack and upload (``apps/batch.FlowUploader``): the program's
``PerfStats`` "upload" (pack into the pinned buffer, which waits for its
last copy, and the one non-blocking copy), mean ms a window step before
the profiler started."""


def read(rec):
    xs = rec.served.perf.get("upload")
    return 1e3 * sum(xs) / len(xs) if xs else None
