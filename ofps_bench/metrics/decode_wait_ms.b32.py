"""Host decode at 32 streams, read as ``decode_wait_ms`` is: the program's
``PerfStats`` "decode", mean ms a window step before the profiler started.
A metric of its own because the cell that reports it moves ``stream_fps``
and not ``step_p95_ms``."""


def read(rec):
    xs = rec.served.perf.get("decode")
    return 1e3 * sum(xs) / len(xs) if xs else None
