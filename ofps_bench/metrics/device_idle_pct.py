"""Device: the share of a window step in which no operation ran on the card,
in %: the device's busy time a traced step, from the profiler's timeline,
against the median host-clock time of the window's steps before the
profiler started.  The profiler slows the host's launches, so the traced
steps last longer and their own idle share is mostly the profiler's; it
lengthens the device's work a step by a few percent only, so where the
device never idles the reading can fall a little below 0."""

import statistics

from ofps_bench import trace


def read(rec):
    tl = rec.timeline
    if tl is None or trace.steps(tl) <= 0:
        return None
    untraced = rec.served.untraced_step_s()
    if not untraced:
        return None
    busy_s = trace.busy_us(tl) / trace.steps(tl) / 1e6
    return 100.0 * (1.0 - busy_s / statistics.median(untraced))
