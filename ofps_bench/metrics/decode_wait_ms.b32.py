"""Host decode at 32 streams (``pipeline/runtime.DecoderFeed``,
``decoders/mvec``): the program's ``PerfStats`` "decode", the main thread's
wait on the B feeds, mean ms a window step before the profiler started."""


def read(rec):
    xs = rec.served.perf.get("decode")
    return 1e3 * sum(xs) / len(xs) if xs else None
