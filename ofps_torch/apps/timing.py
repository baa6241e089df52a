"""Timing windows of the port's measurement tools (:mod:`~ofps_torch.apps.bench`,
``bench_estimators``, ``profile_pipeline``, ``profile_libmv``, ``perf_lab``).

On the card a window is two CUDA events around the enqueued work, with the
host's enqueue time beside it, and it ends on ``.item()`` of the work's
scalar checksum, so every output is computed before the clock stops.
:func:`graph_ms` is the device-only time: N calls recorded in one CUDA
graph and replayed, so that the host's launch cost drops out.  On the CPU
(the tests) a window is a host clock, and no number is a device time.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Optional

import torch


def clock_name(device: torch.device) -> str:
    return "CUDA events" if device.type == "cuda" else "host clock"


def timed(fn: Callable[[], torch.Tensor], device: torch.device):
    """(ms, host enqueue ms, value) of ``fn()``, which returns a 0-d
    tensor: CUDA events on the card (the device is idle before the
    window), a host clock on the CPU; ``value`` is the tensor's ``.item()``."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    out = fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    if cuda:
        end.record()
    value = out.item()
    ms = start.elapsed_time(end) if cuda else (time.perf_counter() - t0) * 1e3
    return ms, host_ms, value


def graph_ms(fn: Callable[[], object], n: int, device: torch.device, reps: int = 3) -> float:
    """Device ms per call of ``fn`` (card only): after a warm-up call, ``fn``
    runs ``n`` times inside one CUDA graph capture, and the graph is
    replayed ``reps`` times between two CUDA events.  ``fn`` must not
    synchronise or copy from the host (its warm-up fills such caches)."""
    fn()
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (n * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


def run_chain(fn: Callable, carry, iters: int, start: int = 0):
    """``iters`` chained calls ``carry, s = fn(carry, i)``: (the last
    carry, the sum of the ``s``)."""
    acc = None
    for i in range(start, start + iters):
        carry, s = fn(carry, i)
        acc = s if acc is None else acc + s
    return carry, acc


def time_stage(fn: Callable, carry0, iters: int, repeats: int, device: torch.device,
               capture: bool, graph_calls: int = 20) -> dict:
    """One stage of a profile: ``fn(carry, i) -> (carry, scalar)`` chained
    ``iters`` times from ``carry0`` after one warm-up call, ``repeats``
    windows (:func:`timed`); per call: ``ms`` of each window, ``host_ms``
    (enqueue), ``best``, ``median``, and on the card, where ``capture``,
    ``device_ms`` from a graph of ``graph_calls`` chained calls (else
    None)."""
    run_chain(fn, carry0, 1)
    ms, host = [], []
    for _ in range(repeats):
        m, h, _ = timed(lambda: run_chain(fn, carry0, iters)[1], device)
        ms.append(m / iters)
        host.append(h / iters)
    dev_ms: Optional[float] = None
    if capture and device.type == "cuda":
        dev_ms = graph_ms(lambda: run_chain(fn, carry0, graph_calls), 1, device) / graph_calls
    return {"ms": ms, "host_ms": host, "best": min(ms), "median": statistics.median(ms),
            "device_ms": dev_ms}
